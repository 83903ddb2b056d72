"""Tokenizer abstraction for Groma's extended vocabulary.

The reference relies on HF LlamaTokenizer + ``add_tokens`` for the 114
added protocol tokens (reference: groma/train/train.py:83-91).  Here the same
contract sits behind a tiny interface so tests run without sentencepiece
and the protocol ids are *derived* (base vocab + fixed order,
data/tokenization.py) instead of queried per token.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from groma_tpu_torch.constants import (ALL_PROTOCOL_TOKENS, DEFAULT_TOKENS,
                                 NEW_TOKENS)
from groma_tpu_torch.data.tokenization import SpecialIds

_SPECIAL_RE = re.compile(
    '(' + '|'.join(re.escape(t) for t in
                   sorted(ALL_PROTOCOL_TOKENS, key=len, reverse=True)) + ')')


class BaseTokenizer:
    """Interface: encode text (handling protocol tokens inline), expose
    SpecialIds, decode for eval output parsing."""
    base_vocab: int
    model_max_length: int = 2048

    @property
    def sp(self) -> SpecialIds:
        return SpecialIds.from_base_vocab(self.base_vocab)

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        raise NotImplementedError

    def decode(self, ids) -> str:
        raise NotImplementedError


class HFTokenizer(BaseTokenizer):
    """Wrap a HF tokenizer that already carries the 114 added tokens in
    reference order (or add them, mirroring train.py:83-91)."""

    def __init__(self, path_or_tok, model_max_length: int = 2048):
        if isinstance(path_or_tok, str):
            from transformers import AutoTokenizer
            tok = AutoTokenizer.from_pretrained(path_or_tok, use_fast=True)
        else:
            tok = path_or_tok
        self.tok = tok
        self.base_vocab = tok.vocab_size
        self.model_max_length = model_max_length
        existing = set(tok.get_vocab().keys())
        missing = [t for t in NEW_TOKENS if t not in existing]
        if missing:
            # keep reference order: add all protocol tokens at once
            tok.add_tokens(missing)
        # verify the id layout matches the derived SpecialIds
        sp = self.sp
        img_id = tok.convert_tokens_to_ids(DEFAULT_TOKENS['image'])
        assert img_id == sp.image, (img_id, sp.image)

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = self.tok(text, add_special_tokens=add_bos,
                       truncation=True,
                       max_length=self.model_max_length).input_ids
        return np.asarray(ids, np.int64)

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=False)


class SPMTokenizer(BaseTokenizer):
    """LLaMA tokenizer.model via the pure-python sentencepiece BPE reader
    (data/spm.py) + the 114 added protocol tokens in reference order —
    covers Vicuna checkpoints when neither sentencepiece nor a fast
    tokenizer.json is available."""

    def __init__(self, model_path: str, model_max_length: int = 2048):
        from groma_tpu_torch.data.spm import SentencePieceBPE
        import os
        if os.path.isdir(model_path):
            model_path = os.path.join(model_path, 'tokenizer.model')
        self.spm = SentencePieceBPE(model_path)
        self.base_vocab = self.spm.vocab_size
        self.model_max_length = model_max_length
        self._special = {t: self.base_vocab + i
                         for i, t in enumerate(NEW_TOKENS)}
        self._special['<s>'] = 1
        self._special['</s>'] = 2
        self._special['<unk>'] = 0

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids: List[int] = [1] if add_bos else []
        for piece in _SPECIAL_RE.split(text):
            if not piece:
                continue
            if piece in self._special:
                ids.append(self._special[piece])
            else:
                ids.extend(self.spm.encode(piece, add_bos=False))
        return np.asarray(ids[:self.model_max_length], np.int64)

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self._special.items()}
        out, plain = [], []
        for i in ids:
            i = int(i)
            if i in inv and i >= self.base_vocab:
                if plain:
                    out.append(self.spm.decode(plain))
                    plain = []
                out.append(inv[i])
            else:
                plain.append(i)
        if plain:
            out.append(self.spm.decode(plain))
        return ' '.join(out)


def load_tokenizer(path: str, model_max_length: int = 2048) -> BaseTokenizer:
    """HF fast tokenizer if tokenizer.json exists, else the pure-python
    sentencepiece reader (tokenizer.model)."""
    import os
    if os.path.exists(os.path.join(path, 'tokenizer.json')):
        return HFTokenizer(path, model_max_length)
    if os.path.exists(os.path.join(path, 'tokenizer.model')):
        return SPMTokenizer(path, model_max_length)
    return HFTokenizer(path, model_max_length)


class StubTokenizer(BaseTokenizer):
    """Deterministic word-hash tokenizer for tests: protocol tokens map to
    their derived ids, everything else hashes into the base vocab."""

    def __init__(self, base_vocab: int = 256, model_max_length: int = 512):
        self.base_vocab = base_vocab
        self.model_max_length = model_max_length
        self._special = {t: base_vocab + i for i, t in enumerate(NEW_TOKENS)}
        self._special['<s>'] = 1
        self._special['</s>'] = 2
        self._special['<unk>'] = 0
        self._bos, self._eos = 1, 2

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids: List[int] = [self._bos] if add_bos else []
        for piece in _SPECIAL_RE.split(text):
            if not piece:
                continue
            if piece in self._special:
                ids.append(self._special[piece])
            else:
                for word in piece.split():
                    ids.append(10 + hash(word) % (self.base_vocab - 10))
        return np.asarray(ids[:self.model_max_length], np.int64)

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self._special.items()}
        return ' '.join(inv.get(int(i), f'w{int(i)}') for i in ids)
