"""The port's roofline: the three-term model of a mesh step on the H100
(``analysis``) and the terms with the CUDA kernels' own traffic
(``kernel_adjust``).

Counterpart of ``src/repro/roofline/``.
"""
