"""Plain float64 references and the comparison that decides `correct`; they import nothing of the program."""
