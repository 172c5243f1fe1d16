from .bpe import CONTEXT_LENGTH, Tokenizer, bytes_to_unicode, load_merges
from .prompts import (
    BANKS,
    TEMPLATES_EMPTY,
    TEMPLATES_SELECT,
    TEMPLATES_SIMPLE,
    TEMPLATES_STANDARD,
    get_bank,
)

__all__ = [
    "Tokenizer",
    "CONTEXT_LENGTH",
    "bytes_to_unicode",
    "load_merges",
    "BANKS",
    "TEMPLATES_EMPTY",
    "TEMPLATES_SELECT",
    "TEMPLATES_SIMPLE",
    "TEMPLATES_STANDARD",
    "get_bank",
]
