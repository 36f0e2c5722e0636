"""Byte-level tokenizer stub (self-contained; no vocab downloads)."""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    def __init__(self, vocab_size: int = 256) -> None:
        if vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b % self.vocab_size for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")
