"""Standalone BERT WordPiece tokenizer (port of
lavender_tpu/data/tokenizer.py, the same code: it imports nothing of torch
or JAX).

Drop-in replacement for the subset of ``transformers.BertTokenizer`` the
reference uses (dataset.py:23-38,258-276): ``tokenize``,
``convert_tokens_to_ids``, ``encode(padding='max_length', truncation=True)``,
special-token ids, and decode.  Compatible with the standard
``bert-base-uncased`` ``vocab.txt`` (the repo's ``assets/vocab_30k.txt``).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(w) for w in out]


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
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


class BertTokenizer:
    """WordPiece tokenizer with the HF-compatible call surface used here."""

    def __init__(self, vocab_path_or_dict, do_lower_case: bool = True):
        if isinstance(vocab_path_or_dict, dict):
            self.vocab = dict(vocab_path_or_dict)
        else:
            self.vocab = {}
            with open(vocab_path_or_dict, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(self.vocab)

        self.pad_token, self.unk_token = "[PAD]", "[UNK]"
        self.cls_token, self.sep_token, self.mask_token = (
            "[CLS]", "[SEP]", "[MASK]")
        (self.pad_token_id, self.unk_token_id, self.cls_token_id,
         self.sep_token_id, self.mask_token_id) = self.convert_tokens_to_ids(
            [self.pad_token, self.unk_token, self.cls_token,
             self.sep_token, self.mask_token])

    def __len__(self):
        return len(self.vocab)

    @property
    def vocab_size(self):
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str, padding: Optional[str] = None,
               max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        """[CLS] tokens [SEP], with HF-style truncation-then-pad."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation and max_length is not None:
            ids = ids[: max(0, max_length - 2)]
        out = [self.cls_token_id] + ids + [self.sep_token_id]
        if padding == "max_length" and max_length is not None:
            out = out + [self.pad_token_id] * (max_length - len(out))
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in SPECIAL_TOKENS]
        text = " ".join(toks).replace(" ##", "")
        return text.strip()


def build_test_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """Small deterministic vocab for offline tests (bert-vocab-shaped)."""
    words = list(SPECIAL_TOKENS)
    words += [str(i) for i in range(10)]
    words += list("abcdefghijklmnopqrstuvwxyz")
    words += ["true", "false", "video", "text", "is", "the", "a", "an",
              "paired", "or", "answer", "question", "option", "correct",
              "which", "what", "man", "woman", "dog", "cat", "playing",
              "person", "talking", "about", "##ing", "##s", "##ed", ".",
              ",", "?", ":", "from", "to", "of", "in", "on", "and"]
    words += list(extra_words)
    seen, vocab = set(), {}
    for w in words:
        if w not in seen:
            vocab[w] = len(vocab)
            seen.add(w)
    return vocab
