"""The benchmark's plain reference: a frozen copy of the program's NumPy oracle
and the code that runs it over a clip on the host's cores."""
