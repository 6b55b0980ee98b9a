"""One module per way of driving the program; a traffic mix names its
driver (``"driver"``) and the harness imports ``gpubench.drivers.<name>``.

A driver's ``run(ctx)`` sets up the program, runs the window, closes it,
reads the program's device and memory, frees the program, and runs the
reference over what the window produced. It returns the cell's end-to-end
values, what the per-layer readers read, the compared numbers and the
device. ``common.py`` holds what the serving drivers share.
"""
