"""Studies of the port: the paper's own evaluation, run through the port.

  * :mod:`paper_tables` — Fig. 2a / 2b and the Table-I sensitivity grid
    (counterpart of ``benchmarks/paper_tables.py``)
"""
