"""Set-up: process start to the first timed call (imports, kernel build
or load, state or weights made on the device, the pool opened, every
shape the window uses warmed)."""


def read(run):
    return run["setup_s"]
