"""The port's kernels: hand-written Hopper kernels beside plain versions.

``ops`` dispatches each entry point (``event_race``, ``flash_attention``,
``selective_scan``, ``selective_scan_step``) to its CUDA kernel
(``des_step``, ``flash_attention``, ``mamba_scan``) or its plain PyTorch
version (``ref``).
"""
