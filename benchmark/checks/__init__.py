"""What decides `correct`: one module per check, named in a cell file's
``"checks"`` with its parameters, found by name.

A check's `Check` takes its probes on the program as the run goes (after
each set-up frame, before the window, before each window frame, after the
window), keeps what the program produced on the host, and, once the
program's state is freed, hands it with the same inputs to the plain
reference (`reference/`) and returns its readings: gaps, each held to the
cell's limit of the same name.  With `control`, the reference computed in
TF32 takes the program's place.
"""
