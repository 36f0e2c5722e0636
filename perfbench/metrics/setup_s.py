"""End to end: process start to the window's opening: imports, weights,
kernel loads (and, in a checkout's first run, their build), warm-up with
its graph captures, and the lead-in's traffic."""


def read(record):
    return record.extra.get("setup_s")
