"""FasterTokenizer: BERT tokenization at the host edge (the port of
``paddle_tpu/text/tokenizer.py``).

Reference being reproduced: the faster_tokenizer op
(paddle/fluid/operators/string/faster_tokenizer_op.h:126
FasterTokenizerKernel) — BasicTokenizer (lowercase, accent strip,
punctuation/CJK split) + WordpieceTokenizer (greedy longest-match with
'##' continuations) producing input_ids/token_type_ids directly from
string inputs.

Tokenization is the host edge of the pipeline (strings never reach the
device); the output is int64 id Tensors on the current place. Unicode handling delegates to python's str (NFD via unicodedata)
instead of the reference's hand-rolled utf-8 tables.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence, Union

import numpy as np

from ..core.string_tensor import StringTensor
from ..nn.layer.layers import Layer


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing
    and accent stripping (reference BasicTokenizer semantics)."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        out = []
        for ch in text:
            if _is_cjk(ch):
                out.append(f" {ch} ")
            elif unicodedata.category(ch) in ("Cc", "Cf") or ch == "\0":
                continue
            else:
                out.append(ch)
        text = "".join(out)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens


class WordpieceTokenizer:
    """Greedy longest-match-first wordpiece with '##' continuation
    (reference WordPieceTokenizer)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        out, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out


class FasterTokenizer(Layer):
    """BERT tokenization as a Layer: StringTensor/str in, id Tensors out
    (reference faster_tokenizer op surface)."""

    def __init__(self, vocab: Union[Dict[str, int], Sequence[str]],
                 do_lower_case: bool = True, unk_token: str = "[UNK]",
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]"):
        super().__init__()
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(vocab, unk_token)
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab.get(pad_token, 0)

    def _encode(self, text: str) -> List[int]:
        ids = []
        for tok in self.basic.tokenize(text):
            for piece in self.wordpiece.tokenize(tok):
                ids.append(self.vocab[piece])
        return ids

    def forward(self, text, text_pair=None, max_seq_len: int = 0,
                pad_to_max_seq_len: bool = False):
        """Returns (input_ids, token_type_ids) int64 Tensors
        [batch, seq]."""
        from ..ops.creation import to_tensor

        def as_list(x):
            if isinstance(x, StringTensor):
                return [str(s) for s in x.numpy().reshape(-1)]
            if isinstance(x, str):
                return [x]
            return list(x)

        texts = as_list(text)
        pairs = as_list(text_pair) if text_pair is not None else \
            [None] * len(texts)
        rows, types = [], []
        for t, p in zip(texts, pairs):
            a = self._encode(t)
            b = self._encode(p) if p is not None else None
            if max_seq_len:
                # longest-first pairwise truncation (reference
                # BertTokenizer::TruncateSequence,
                # faster_tokenizer_op.cc:294): pop from the longer
                # sequence until CLS + a + SEP (+ b + SEP) fits
                budget = max(max_seq_len - (3 if b is not None else 2),
                             0)
                over = len(a) + (len(b) if b is not None else 0) - budget
                for _ in range(min(max(over, 0),
                                   len(a) + len(b or []))):
                    if not b or len(a) > len(b):
                        a.pop()
                    else:
                        b.pop()
            ids = [self.cls_id] + a + [self.sep_id]
            tt = [0] * len(ids)
            if b is not None:
                second = b + [self.sep_id]
                ids += second
                tt += [1] * len(second)
            if max_seq_len and len(ids) > max_seq_len:
                # hard length contract: never exceed max_seq_len, even
                # when it is below the special-token overhead (the
                # longest-first pops above already fit normal cases, so
                # this clamp only bites the degenerate ones). Keep the
                # terminal [SEP] contract: the last kept token becomes
                # sep_id so consumers relying on a closing separator
                # still see one.
                ids, tt = ids[:max_seq_len], tt[:max_seq_len]
                ids[-1] = self.sep_id
            rows.append(ids)
            types.append(tt)
        width = max(len(r) for r in rows)
        if pad_to_max_seq_len and max_seq_len:
            width = max(width, max_seq_len)
        out = np.full((len(rows), width), self.pad_id, np.int64)
        tt_out = np.zeros((len(rows), width), np.int64)
        for i, (r, t) in enumerate(zip(rows, types)):
            out[i, :len(r)] = r
            tt_out[i, :len(t)] = t
        return (to_tensor(out, dtype="int64"),
                to_tensor(tt_out, dtype="int64"))
