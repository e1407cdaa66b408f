"""Set-up time: from the start of the process to the first timed call
(loading, the build of a kernel library that is not built yet, the
program's init and its first steps, the warm-up), on the host clock."""


def read(run):
    return run.setup_s
