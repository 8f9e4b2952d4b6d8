"""The plain reference that decides `correct`: frozen copies of the
program's model, binding, eval DTW, metrics and planner modules (their
docstrings are the program's), with GroupNorm + LeakyReLU as plain torch
operations (`plain.py`), a plain RAdam (`model.py`), the npz mapping
(`checkpoint.py`) and the evaluation protocol (`evaluate.py`). Nothing here
imports the program, JAX or the JAX package."""
