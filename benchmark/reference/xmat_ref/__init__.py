"""The benchmark's plain reference: a frozen copy of the eager path of the
PyTorch package, taken when the benchmark was defined, so that later changes
to the program do not move the yardstick.

Every function runs op by op in plain PyTorch: FAST and the LK level run
their plain versions on every device (no hand-written kernel, no compiled
program), and the matmul precision is whatever the caller sets (the
benchmark sets float32, TF32 off; its control sets TF32 on). Nothing here
imports the measured package, JAX or the JAX package.
"""
