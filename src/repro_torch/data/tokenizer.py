"""Byte-level tokenizer with special tokens (vocab 512 in reflect-demo)."""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 0, 1, 2
BYTE_OFFSET = 3
VOCAB_SIZE = 259  # 3 specials + 256 bytes


class ByteTokenizer:
    pad_id, bos_id, eos_id = PAD, BOS, EOS
    vocab_size = VOCAB_SIZE

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [BYTE_OFFSET + b for b in text.encode("utf-8")]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(i - BYTE_OFFSET for i in ids
                   if i >= BYTE_OFFSET and i - BYTE_OFFSET < 256)
        return bs.decode("utf-8", errors="replace")
