"""The port's program cache (`advancedhmc_torch.aot`), against what JAX's
`tests/test_aot.py` pins for `advancedhmc_tpu.aot`: signatures isolate
programs by identity, structure, shapes and dtypes; a call is bitwise the
program; a fresh process finds the artifact ("cache"); a corrupt one falls
back to "trace" and is overwritten. And the port's own rules: the
artifact is a JSON manifest of kernel libraries (no pickle), the cache
directory is private (0o700, refused when others may write it), a call
with arguments of another structure raises, and `AHMC_AOT_DIR` is read at
call time. On the CPU no kernel library loads; `_build` is pointed at a
scratch directory holding a stand-in library where a test needs one.

Run as a script (`python tests/test_torch_aot.py CACHE_DIR`) it prints the
source `aot_program` reports for the warmup program, in a new process.
"""

import dataclasses
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import advancedhmc_torch as ah
from advancedhmc_torch import aot
from advancedhmc_torch.checkpoint import _flatten
from advancedhmc_torch.ops import _build
from advancedhmc_torch.sampler import fused_warmup_phase_crosschain

DIM, CHAINS = 4, 16
ROOT = Path(__file__).resolve().parent.parent


def _warm_setup(dtype=torch.float64, chains=CHAINS):
    target = ah.std_gaussian(DIM, device="cpu")
    kernel = ah.HMCKernel(ah.Trajectory(
        ah.Leapfrog(step_size=torch.tensor(0.3, dtype=dtype)),
        ah.GeneralisedNoUTurn(max_depth=4)))
    spec = ah.SampleSpec(target=target, kernel=kernel,
                         adaptor=ah.AdaptorConfig(kind="stan"),
                         cross_chain=True)
    theta = 0.2 * torch.randn(chains, DIM, dtype=dtype,
                              generator=torch.Generator().manual_seed(1))
    st0 = ah.init_state(torch.Generator().manual_seed(5), spec,
                        ah.make_metric("diagonal", DIM, dtype, device="cpu"),
                        theta, device="cpu")
    return spec, st0


def _warm_program(spec):
    """A fused cross-chain warmup block, the program bench.py's AOT path
    wraps; it draws from a generator seeded inside, so it is a function
    of its argument."""
    def warm(st):
        return fused_warmup_phase_crosschain(
            torch.Generator().manual_seed(7), spec, st, 16, 8)
    return warm


def _leaves(tree):
    return [x for _, x in _flatten(tree)[0]]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_signature_isolates_identity_structure_shapes_and_dtypes():
    _, st0 = _warm_setup()
    _, st_wide = _warm_setup(chains=2 * CHAINS)
    _, st_f32 = _warm_setup(dtype=torch.float32)
    sigs = {
        aot.aot_signature("warm/16/8", (st0,)),
        aot.aot_signature("warm/32/8", (st0,)),          # identity
        aot.aot_signature("warm/16/8", (st_wide,)),      # shapes
        aot.aot_signature("warm/16/8", (st_f32,)),       # dtypes
        aot.aot_signature("warm/16/8", (st0, st0)),      # structure
        aot.aot_signature("warm/16/8", ([st0],)),        # node kind
    }
    assert len(sigs) == 6
    assert aot.aot_signature("warm/16/8", (st0,)) == \
        aot.aot_signature("warm/16/8", (_warm_setup()[1],))


def test_call_is_bitwise_the_program_and_second_lookup_hits(tmp_path):
    spec, st0 = _warm_setup()
    warm = _warm_program(spec)
    ref = warm(st0)
    call, src = aot.aot_program(warm, (st0,), program_id="warm/16/8",
                                cache_dir=tmp_path)
    assert src == "trace"
    _assert_bitwise(call(st0), ref)
    call2, src2 = aot.aot_program(warm, (st0,), program_id="warm/16/8",
                                  cache_dir=tmp_path)
    assert src2 == "cache"
    _assert_bitwise(call2(st0), ref)


def test_fresh_process_reports_cache(tmp_path):
    spec, st0 = _warm_setup()
    call, src = aot.aot_program(_warm_program(spec), (st0,),
                                program_id="warm/16/8", cache_dir=tmp_path)
    assert src == "trace"
    call(st0)
    out = subprocess.run(
        [sys.executable, __file__, str(tmp_path)], capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "cache"


def test_artifact_is_a_json_manifest_never_a_pickle(tmp_path):
    spec, st0 = _warm_setup()
    call, _ = aot.aot_program(_warm_program(spec), (st0,), program_id="p",
                              cache_dir=tmp_path)
    call(st0)
    files = list(tmp_path.iterdir())
    assert [f.suffix for f in files] == [".json"]
    raw = files[0].read_bytes()
    assert not raw.startswith(b"\x80")            # pickle's protocol mark
    manifest = json.loads(raw)
    assert manifest["signature"] == aot.aot_signature("p", (st0,))
    assert manifest["libraries"] == {}            # nothing loads on the CPU
    assert manifest["device"] == "cpu"


def test_corrupt_manifest_falls_back_and_is_overwritten(tmp_path):
    spec, st0 = _warm_setup()
    warm = _warm_program(spec)
    call, src = aot.aot_program(warm, (st0,), program_id="p",
                                cache_dir=tmp_path)
    call(st0)
    path = tmp_path / f"{aot.aot_signature('p', (st0,))}.json"
    for junk in ("not json", '{"format": 1}', "[1, 2]"):
        path.write_text(junk)
        call, src = aot.aot_program(warm, (st0,), program_id="p",
                                    cache_dir=tmp_path)
        assert src == "trace"
        _assert_bitwise(call(st0), warm(st0))
        assert aot.aot_program(warm, (st0,), program_id="p",
                               cache_dir=tmp_path)[1] == "cache"
    assert not [f for f in tmp_path.iterdir() if f.name.startswith(".")]


def test_call_raises_on_arguments_of_another_structure(tmp_path):
    spec, st0 = _warm_setup()
    _, st_wide = _warm_setup(chains=2 * CHAINS)
    call, _ = aot.aot_program(_warm_program(spec), (st0,), program_id="p",
                              cache_dir=tmp_path)
    for args in ((st_wide,), (st0, st0), (dataclasses.replace(
            st0, z=dataclasses.replace(st0.z, theta=st0.z.theta.float())),)):
        with pytest.raises(ValueError, match="differ from the example"):
            call(*args)


def test_cache_directory_is_private(tmp_path):
    spec, st0 = _warm_setup()
    new = tmp_path / "cache"
    aot.aot_program(_warm_program(spec), (st0,), program_id="p",
                    cache_dir=new)
    assert stat.S_IMODE(new.stat().st_mode) == 0o700
    shared = tmp_path / "shared"
    shared.mkdir()
    shared.chmod(0o777)
    with pytest.raises(PermissionError, match="writable by others"):
        aot.aot_program(_warm_program(spec), (st0,), program_id="p",
                        cache_dir=shared)


def test_cache_dir_is_read_from_the_environment_at_call_time(
        tmp_path, monkeypatch):
    spec, st0 = _warm_setup()
    for sub in ("a", "b"):
        monkeypatch.setenv("AHMC_AOT_DIR", str(tmp_path / sub))
        call, src = aot.aot_program(_warm_program(spec), (st0,),
                                    program_id="p")
        assert src == "trace"
        call(st0)
        assert len(list((tmp_path / sub).glob("*.json"))) == 1


def test_manifest_lists_loaded_libraries_and_goes_stale(tmp_path,
                                                        monkeypatch):
    """The first call records the libraries it loads (a stand-in library
    here: no kernel loads on the CPU); a later lookup loads them and hits;
    a rebuilt source (another library name) or a missing file makes the
    manifest stale."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {"fused_logistic": "stand-in"})
    (tmp_path / "build").mkdir()
    lib = _build.library_path("fused_logistic")
    lib.write_bytes(b"")
    spec, st0 = _warm_setup()

    def prog(st):
        _build.load("fused_logistic")
        return st.z.theta * 2

    cache = tmp_path / "cache"
    call, src = aot.aot_program(prog, (st0,), program_id="k",
                                cache_dir=cache)
    assert src == "trace"
    assert torch.equal(call(st0), st0.z.theta * 2)
    manifest = json.loads(next(cache.glob("*.json")).read_text())
    assert manifest["libraries"] == {"fused_logistic": lib.name}
    assert aot.aot_program(prog, (st0,), program_id="k",
                           cache_dir=cache)[1] == "cache"
    lib.unlink()
    assert aot.aot_program(prog, (st0,), program_id="k",
                           cache_dir=cache)[1] == "trace"


if __name__ == "__main__":
    spec_, st0_ = _warm_setup()
    print(aot.aot_program(_warm_program(spec_), (st0_,),
                          program_id="warm/16/8", cache_dir=sys.argv[1])[1])
