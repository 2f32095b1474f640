"""setup_s: seconds from the start of the process to the start of the
window (host clock): torch and the card, the program's libraries (built
on a checkout's first run), the inputs, and the warm-up requests."""


def read(run):
    return run.setup_s
