"""Prompt token ids that are the same in every process.

Frozen copy (commit 078c4a5) of ``tests/test_torch_viewer_profiling.py::
fixed_tokens``: CLIP-shaped ids (start, one id a word from the word's
CRC-32, end, end-padded). The port's fallback tokenizer maps unknown words
through Python's salted ``hash``, so its ids, and with them the scene,
change from process to process; the benchmark installs this one as the
pipeline's tokenizer instead.
"""
from __future__ import annotations

import zlib

import numpy as np

CONTEXT = 77
SOT, EOT = 49406, 49407


def fixed_tokens(prompts) -> np.ndarray:
    """``(B, 77)`` int32 ids."""
    if isinstance(prompts, str):
        prompts = [prompts]
    out = np.full((len(prompts), CONTEXT), EOT, dtype=np.int32)
    for i, prompt in enumerate(prompts):
        ids = [SOT] + [zlib.crc32(w.encode()) % SOT
                       for w in prompt.split()][:CONTEXT - 2] + [EOT]
        out[i, :len(ids)] = ids
    return out
