"""Host runtime of the port: the prefetching batch loader, the float32 →
bfloat16 cast and the byte-level BPE tokenizer, over the native library
(``native/``, built into ``build/native/`` at first use) with numpy and
Python paths where it is unavailable."""
from autodist_tpu_torch.runtime.data_loader import DataLoader
from autodist_tpu_torch.runtime.native import fp32_to_bf16, native_available
from autodist_tpu_torch.runtime.tokenizer import BPETokenizer

__all__ = ["BPETokenizer", "DataLoader", "fp32_to_bf16", "native_available"]
