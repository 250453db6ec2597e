"""Traffic: the frames a cell hands to the program, made from its seed.

`orbit.py` (the synthetic box room and its orbit) and `street.py` (the
closed street lap) are frozen copies of the port's generators
(`io/synthetic.py`, `io/street.py`), numpy only, so that a later change to
the program leaves the traffic as it is.  `frames.py` is the one general
generator that a cell's traffic parameters drive.
"""
