"""audio_rag_tpu_torch — the PyTorch/CUDA port of ``audio_rag_tpu``.

The JAX package beside it stays the reference. This package imports torch,
numpy and the standard library only; it never imports jax or anything of
``audio_rag_tpu``. Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``; every TPU kernel on the ported path is a CUDA C++
kernel under ``csrc/``, reached through :mod:`audio_rag_tpu_torch.ops.kernels`.

The ported slice is speech → Whisper → chunk → BGE-M3 embed → hybrid search
(:class:`audio_rag_tpu_torch.pipeline.AudioRAG`).
"""

__version__ = "0.1.0"
