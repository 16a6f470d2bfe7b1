"""swiftllm-tpu-torch: the PyTorch/CUDA port of swiftllm-tpu, for one NVIDIA
Hopper GPU (H100).

It mirrors the JAX package's modules and names and imports nothing of it
(or of JAX). Paged attention runs in CUDA kernels written by hand
(``ops/csrc``); everything else is plain PyTorch. Entry points run on
``device="cuda"`` unless the caller asks for ``"cpu"``, where the kernels'
plain PyTorch versions run instead.
"""

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.structs import RawRequest, Request, StepOutput

__all__ = ["EngineConfig", "LlamaModelConfig", "RawRequest", "Request",
           "StepOutput"]
