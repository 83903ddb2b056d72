"""Pure-python SentencePiece BPE tokenizer (reads tokenizer.model).

The reference loads Vicuna's LlamaTokenizer through the sentencepiece C++
library (reference: groma/train/train.py:69-76 use_fast=False).  That
library isn't available here, so this module parses the SentencePiece
``ModelProto`` wire format directly and implements BPE encoding with byte
fallback — enough for LLaMA-family tokenizer.model files.

Scope: BPE model type (LLaMA/Vicuna), add_dummy_prefix + whitespace-escape
normalization, byte fallback.  Unigram models are out of scope (LLaMA
does not use them).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

WS = '▁'   # the sentencepiece whitespace marker


# ------------------------------------------------------- protobuf parsing

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:                    # fixed64
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:                    # length-delimited
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:                    # fixed32
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, val


def parse_model_proto(data: bytes):
    """Returns list of (piece, score, type) from a ModelProto blob.

    ModelProto.pieces = field 1 (repeated SentencePiece);
    SentencePiece: piece=1 (string), score=2 (float), type=3 (enum;
    1=NORMAL, 2=UNKNOWN, 3=CONTROL, 6=BYTE).
    """
    import struct
    pieces = []
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:
            piece, score, ptype = '', 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode('utf-8', errors='replace')
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack('<f', v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    return pieces


# ------------------------------------------------------------- tokenizer

class SentencePieceBPE:
    """BPE encode/decode over a parsed sentencepiece model."""

    TYPE_NORMAL, TYPE_UNKNOWN, TYPE_CONTROL, TYPE_BYTE = 1, 2, 3, 6

    def __init__(self, model_path_or_bytes):
        if isinstance(model_path_or_bytes, (str, bytes)) and \
                not isinstance(model_path_or_bytes, bytes):
            with open(model_path_or_bytes, 'rb') as f:
                data = f.read()
        else:
            data = model_path_or_bytes
        self.pieces = parse_model_proto(data)
        self.piece_to_id: Dict[str, int] = {
            p: i for i, (p, _, _) in enumerate(self.pieces)}
        self.scores = [s for (_, s, _) in self.pieces]
        self.types = [t for (_, _, t) in self.pieces]
        self.unk_id = next((i for i, t in enumerate(self.types)
                            if t == self.TYPE_UNKNOWN), 0)
        self.byte_ids = {i: int(p[1:-1], 16) for i, (p, _, t)
                         in enumerate(self.pieces) if t == self.TYPE_BYTE}

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def _bpe(self, chars: List[str]) -> List[str]:
        """Greedy highest-score adjacent merges (sentencepiece BPE)."""
        while len(chars) > 1:
            best, best_score = -1, None
            for j in range(len(chars) - 1):
                cand = chars[j] + chars[j + 1]
                pid = self.piece_to_id.get(cand)
                if pid is not None and self.types[pid] == self.TYPE_NORMAL:
                    sc = self.scores[pid]
                    if best_score is None or sc > best_score:
                        best, best_score = j, sc
            if best < 0:
                break
            chars = chars[:best] + [chars[best] + chars[best + 1]] \
                + chars[best + 2:]
        return chars

    def encode(self, text: str, add_bos: bool = True,
               bos_id: int = 1) -> List[int]:
        text = WS + text.replace(' ', WS)      # add_dummy_prefix + escape
        out: List[int] = [bos_id] if add_bos else []
        pieces = self._bpe(list(text))
        for p in pieces:
            pid = self.piece_to_id.get(p)
            if pid is not None:
                out.append(pid)
                continue
            # byte fallback
            for byte in p.encode('utf-8'):
                bid = self.piece_to_id.get(f'<0x{byte:02X}>')
                out.append(bid if bid is not None else self.unk_id)
        return out

    def decode(self, ids) -> str:
        frags: List[bytes] = []
        for i in ids:
            i = int(i)
            if i in self.byte_ids:
                frags.append(bytes([self.byte_ids[i]]))
            elif 0 <= i < len(self.pieces):
                piece, _, t = self.pieces[i]
                if t in (self.TYPE_CONTROL, self.TYPE_UNKNOWN):
                    continue
                frags.append(piece.encode('utf-8'))
        text = b''.join(frags).decode('utf-8', errors='replace')
        return text.replace(WS, ' ').lstrip(' ')


def build_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Serialize a minimal ModelProto (for tests / synthetic models)."""
    import struct

    def varint(v: int) -> bytes:
        out = b''
        while True:
            b = v & 0x7F
            v >>= 7
            out += bytes([b | (0x80 if v else 0)])
            if not v:
                return out

    blob = b''
    for piece, score, ptype in pieces:
        pb = piece.encode('utf-8')
        body = (bytes([0x0A]) + varint(len(pb)) + pb
                + bytes([0x15]) + struct.pack('<f', score)
                + bytes([0x18]) + varint(ptype))
        blob += bytes([0x0A]) + varint(len(body)) + body
    return blob
