"""Host runtime of the port: the byte-level BPE tokenizer (pure Python).
The JAX package's data loader, bf16 cast and native tokenizer encode come
with ROADMAP P12."""
from autodist_tpu_torch.runtime.tokenizer import BPETokenizer

__all__ = ["BPETokenizer"]
