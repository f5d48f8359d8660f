"""The analyzers of the PyTorch port (the port of flashy_tpu.analysis).

Only the fault-site registry is here (`registry.py`, data the chaos
campaign sweeps). The AST, trace and numerics analyzers wait for
ROADMAP.md queue A item 12.
"""
