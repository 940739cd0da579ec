"""The benchmark's plain reference: float64 PyTorch, written from the physics.

It imports nothing of the program under test and takes nothing the program
made: every constant, factor, propagator, transfer function, probe and mask
is derived here again from the configuration's numbers and the benchmark's
own inputs (atoms, positions, observed data).
"""
