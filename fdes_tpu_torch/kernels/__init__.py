"""Kernels written by hand for Hopper, one module per ``fdes_tpu/pallas/`` file.

Sources live in ``fdes_tpu_torch/csrc/`` and build on first use
(``_build.py``); importing this package builds nothing.
"""
