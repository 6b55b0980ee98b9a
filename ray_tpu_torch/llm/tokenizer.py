"""Tokenizers (own copy of ray_tpu/llm/tokenizer.py): ByteTokenizer and
load_tokenizer."""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 bytes + BOS/EOS/PAD. vocab = 256 + 3 specials."""

    PAD = 256
    BOS = 257
    EOS = 258
    vocab_size = 259
    byte_level = True

    @property
    def eos_token_id(self) -> int:
        return self.EOS

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")



def load_tokenizer(spec: str | None):
    """None or "byte" → ByteTokenizer; otherwise a local tokenizer
    directory through transformers.AutoTokenizer (imported here, so a
    machine without transformers raises ImportError for a directory spec
    and never falls back to bytes). Nothing is downloaded."""
    if spec is None or spec == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(spec, local_files_only=True)
