"""setup_s (s, host clock): from the start of the process to the first
timed call: imports, the CUDA contexts, the program's libraries (built at
the first run in a checkout, loaded from build/ after), the clip, the
request (a decode cell's stream) and one warm call of the cell's shapes."""


def read(run):
    return run.setup_s
