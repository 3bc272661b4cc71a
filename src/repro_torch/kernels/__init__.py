"""The port's kernels: hand-written Hopper kernels beside plain versions.

``ops`` dispatches each entry point (``event_race``, ``flash_attention``,
``selective_scan``, ``selective_scan_step``) to its CUDA kernel
(``des_step``, ``flash_attention``, ``mamba_scan``) or its plain PyTorch
version (``ref``).  ``ctmc_chunk`` runs a chunk of CTMC steps in one
launch; the CTMC engine (``core.vectorized``) dispatches it itself, as its
plain version is the engine's own step loop.
"""
