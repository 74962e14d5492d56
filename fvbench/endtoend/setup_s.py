"""Seconds from the process's start to the window's start: drawing the
tables, uploading them, building the decoder, the pool and one warm-up
request of the cell's shape."""


def read(w):
    return w.setup_s
