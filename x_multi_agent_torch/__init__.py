"""x_multi_agent_torch: the collaborative VIO engine on PyTorch + CUDA.

A port of ``x_multi_agent_tpu`` (the JAX reference, which stays beside it)
to PyTorch, with the reference's Pallas TPU kernels rewritten as CUDA C++
kernels for Hopper (``csrc/``). The subpackages and module names mirror the
reference, so ``x_multi_agent_torch/vio/pipeline.py`` is the counterpart of
``x_multi_agent_tpu/vio/pipeline.py``.

Idiom:
  * plain functions on tensors; ``@dataclass`` state containers in place of
    pytrees; parameter sets stay ``NamedTuple``s of Python scalars;
  * the agent axis is an explicit leading batch dimension on every state
    tensor (no vmap). Per-agent ``lax.cond`` under ``vmap`` becomes both
    branches + ``torch.where``;
  * every public function works on the device of the tensors it is given;
    the entry points and state constructors that take ``device`` default
    to the CUDA card (``device.resolve``) and raise where there is none:
    CPU callers pass ``device="cpu"``;
  * filter algebra runs in full fp32 on the card: callers disable TF32
    (``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``); ``vio.frame_step``
    raises on CUDA tensors when TF32 matmuls are on.

The package never imports JAX.
"""

__version__ = "0.1.0"
