"""CLIP byte-pair-encoding tokenizer (vocab.json + merges.txt loader).

A copy of ``gaussctrl_exp_tpu/diffusion/tokenizer.py`` (the port imports
nothing of the JAX package): byte-level BPE over the CLIP vocab, lowercased,
whitespace-normalised, with the ``</w>`` end-of-word marker, the
``<|startoftext|>``/``<|endoftext|>`` specials and padding to 77 with the eos
token, reading the ``vocab.json``/``merges.txt`` of a diffusers checkpoint.
Held against the JAX package's tokenizer by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path

import numpy as np

try:  # \p{L}/\p{N} classes need the `regex` module (a transformers dep)
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII-only fallback, adequate for English prompts
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""",
        re.IGNORECASE,
    )

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
MAX_LEN = 77  # CLIP ViT-L/14 text tower context


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte → printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word convention.

    Args:
      vocab: token string → id (the contents of vocab.json).
      merges: ordered list of merge pairs (the lines of merges.txt).
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_id = self.encoder[BOS]
        self.eos_id = self.encoder[EOS]
        self.pad_id = self.eos_id  # HF CLIPTokenizer pads SD prompts with eos
        self._cache: dict[str, list[str]] = {BOS: [BOS], EOS: [EOS]}

    # ---- file loading ------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_path: str | Path, merges_path: str | Path) -> "CLIPTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_pretrained(cls, root: str | Path) -> "CLIPTokenizer":
        """Load from a diffusers checkpoint dir (``<root>/tokenizer/``) or a
        bare tokenizer dir containing vocab.json + merges.txt."""
        root = Path(root)
        for d in (root / "tokenizer", root):
            if (d / "vocab.json").exists() and (d / "merges.txt").exists():
                return cls.from_files(d / "vocab.json", d / "merges.txt")
        raise FileNotFoundError(f"no vocab.json/merges.txt under {root}")

    # ---- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Text → BPE ids (no specials, no padding)."""
        text = whitespace_clean(text).lower()
        ids: list[int] = []
        for tok in _PAT.findall(text):
            tok_b = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok_b))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids if int(i) not in (self.bos_id,))
        text = text.replace(EOS, "")
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, max_len: int = MAX_LEN) -> np.ndarray:
        """Batch encode with bos/eos + truncation + eos-padding → (B, max_len)
        int32, matching HF ``tokenizer(texts, padding="max_length",
        max_length=77, truncation=True).input_ids``."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_len), self.pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_id] + self.encode(t)[: max_len - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def make_test_vocab() -> tuple[dict[str, int], list[tuple[str, str]]]:
    """A structurally-real miniature CLIP vocab for offline tests: the 256
    byte symbols, their </w> forms, a handful of merges, and the specials —
    the exact layout of the real 49,408-entry vocab, minus 48k merges."""
    base = list(bytes_to_unicode().values())
    tokens = base + [c + "</w>" for c in base]
    merges = [
        ("t", "h"),
        ("th", "e</w>"),
        ("a", "n"),
        ("an", "d</w>"),
        ("i", "n</w>"),
        ("b", "e"),
        ("be", "a"),
        ("bea", "r</w>"),
        ("o", "f</w>"),
        ("t", "o</w>"),
        ("a", "t</w>"),
        ("s", "t"),
        ("st", "a"),
        ("t", "u"),
        ("e</w>", ""),  # replaced below; placeholder never matches
    ][:-1]
    tokens += ["".join(m).replace("</w>", "") + ("</w>" if m[1].endswith("</w>") else "") for m in merges]
    # dedupe preserving order
    seen = set()
    uniq = [t for t in tokens if not (t in seen or seen.add(t))]
    uniq += [BOS, EOS]
    vocab = {t: i for i, t in enumerate(uniq)}
    return vocab, merges
