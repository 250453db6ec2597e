"""The plain reference that decides a run's `correct`.

Frozen copies of the port's op-by-op arithmetic as it stood when this
benchmark was written: preprocess, pyramids, SO3 pre-align and ICP+RGB
Gauss-Newton tracking, the NID gate, the splat render, fusion and fill-in
(`step.py`), and the deformation graph's Gauss-Newton/CG solve and apply
(`deformation.py`, `deform.py`).  The program's hand kernels are replaced
by their plain versions (`plain.gram` for K1, `deform.deform_map_reference`
for K2), its graph branches by Python `if`s, and nothing here imports the
program: a later change to the program leaves this yardstick as it is.
`checks.py` holds the comparisons.
"""
