"""p3achygo_tpu_torch: the PyTorch + CUDA port of p3achygo_tpu.

Same layout and names as the JAX package beside it (`game/board.py`,
`ops/liberties.py`, `mcts/gumbel.py`, ...), written as batch-first tensor
code with an explicit `device` and an explicit `torch.Generator` for every
random draw. The JAX package is the reference every module is tested
against (tests/test_torch_*.py). Importing this package loads no JAX.
"""
__version__ = "0.1.0"
