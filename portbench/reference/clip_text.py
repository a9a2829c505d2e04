# Frozen copy of prometheus_torch/models/clip_text.py at commit 078c4a5; imports
# rewritten to this package, kernel A replaced by plain attention.
"""CLIP text encoder (OpenCLIP ViT-H tower, as SD-2.1 uses it) and its BPE
tokenizer (``prometheus_tpu/models/clip_text.py``).

Vocab 49408, width 1024, 16 heads, 23 layers (SD-2.1 truncates the tower at
the penultimate layer), causal mask, final LayerNorm, context 77. The
tokenizer is plain Python: byte-level pre-encoding plus merge ranks from a
``bpe_simple_vocab_16e6`` merges file. Without one, Python's ``hash`` of
each token stands in (wrong ids, right shapes and specials), so every stage
still runs offline; as in the JAX package, those ids hold within one
process only, since Python salts string hashes per process. The text attention is 77 tokens with a causal mask and stays off
the flash kernel, as in the JAX package.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 reversible byte<->unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    """CLIP BPE tokenizer (merges-file driven; hash fallback without one)."""

    # ASCII approximation of CLIP's \p{L}/\p{N} pattern (stdlib `re` has no
    # unicode property classes); identical on English prompts.
    PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = _bytes_to_unicode()
        self.sot = VOCAB_SIZE - 2  # 49406
        self.eot = VOCAB_SIZE - 1  # 49407
        self.bpe_ranks = None
        self.encoder = None
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as fp:
                merges = fp.read().split("\n")
            merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1] if m]
            vocab = list(_bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
            self._cache = {}
        elif bpe_path:
            raise FileNotFoundError(
                f"BPE merges file not found: {bpe_path}; omit bpe_path to "
                "opt into the hash fallback")
        else:
            warnings.warn(
                "CLIPTokenizer constructed WITHOUT a merges file: using the "
                "hash fallback (wrong token ids, right shapes). Python salts "
                "hash() per process, so the ids, and everything generated "
                "from a prompt, change between processes unless "
                "PYTHONHASHSEED is set. Converted real text-encoder weights "
                "need the exact BPE: pass bpe_path "
                "(bpe_simple_vocab_16e6.txt[.gz]).",
                stacklevel=2)

    @property
    def is_exact(self) -> bool:
        return self.bpe_ranks is not None

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _basic_clean(text)
        ids: list[int] = []
        for tok in re.findall(self.PAT, text):
            tok_b = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            if self.is_exact:
                ids.extend(self.encoder[t] for t in self._bpe(tok_b).split(" "))
            else:
                # fallback: the token's hash (salted per process, as in the
                # JAX package) into the BPE id range
                ids.append(hash(tok_b) % (VOCAB_SIZE - 2))
        return ids

    def __call__(self, texts, max_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Padded ``(B, max_length)`` int32 ids: sot, tokens, eot, then eot
        padding (the HF tokenizer the reference uses pads with eot)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.eot, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: max_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class CLIPMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        # OpenCLIP ViT-H's text tower uses the exact (erf) gelu
        return self.fc2(F.gelu(self.fc1(x)))


class CLIPAttention(nn.Module):
    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal_mask):
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = (lin(x).reshape(b, t, self.num_heads, d)
                   for lin in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        logits = logits * (d ** -0.5) + causal_mask
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)
        return self.out_proj(out)


class CLIPLayer(nn.Module):
    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, num_heads)
        self.ln2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = CLIPMLP(width)

    def forward(self, x, causal_mask):
        x = x + self.attn(self.ln1(x), causal_mask)
        return x + self.mlp(self.ln2(x))


class CLIPTextModel(nn.Module):
    """``(B, 77)`` ids -> per-token hidden states ``(B, 77, width)`` after
    the final LayerNorm."""

    def __init__(self, vocab_size: int = VOCAB_SIZE, width: int = 1024,
                 num_heads: int = 16, num_layers: int = 23,
                 context_length: int = CONTEXT_LENGTH):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(width, num_heads))
        self.final_ln = nn.LayerNorm(width, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        t = input_ids.shape[1]
        x = self.token_embedding(input_ids.long())
        x = x + self.position_embedding[:t].to(x.dtype)
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device),
                          diagonal=1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.final_ln(x)
