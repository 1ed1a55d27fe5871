"""Self-contained BPE tokenizer: HF tokenizer.json loader + trainer.

A copy of ``fedml_tpu/train/llm/tokenizer.py`` (framework-free), so the
port's serving path encodes and decodes text to the JAX package's ids.

Reference: the FedLLM path tokenizes with HF AutoTokenizer
(``train/llm/train_utils.py``, ``configurations.py:376`` DatasetArguments).
Zero egress here, so this module (a) parses a *local* HF ``tokenizer.json``
(the fast-tokenizer serialization used by llama/gpt2 checkpoints) and runs
its BPE merges natively, and (b) can train a byte-level BPE from raw text so
every pipeline works with no downloaded assets at all.

Supported tokenizer.json pretokenizers: Metaspace (llama: ' ' -> '▁',
byte_fallback <0xNN> tokens) and ByteLevel (gpt2: bytes -> printable
unicode). That covers the model families the reference fine-tunes.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_METASPACE = "▁"


def _bytelevel_table() -> Dict[int, str]:
    """GPT-2 byte -> unicode printable mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_B2U = _bytelevel_table()
_U2B = {u: b for b, u in _B2U.items()}


class BPETokenizer:
    """Greedy-merge BPE over a vocab + ranked merge list."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        mode: str = "byte_level",           # byte_level | metaspace
        byte_fallback: bool = False,
        unk_token: Optional[str] = None,
        special_tokens: Optional[Dict[str, int]] = None,
        add_prefix_space: bool = True,
    ):
        self.vocab = dict(vocab)
        self.merge_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.mode = mode
        self.byte_fallback = byte_fallback
        self.unk_token = unk_token
        self.special_tokens = dict(special_tokens or {})
        self.add_prefix_space = add_prefix_space
        self.id_to_token = {i: t for t, i in {**self.vocab, **self.special_tokens}.items()}

    # --- encoding --------------------------------------------------------
    def _bpe_word(self, symbols: List[str]) -> List[str]:
        """Apply merges to one pretoken (lowest-rank pair first)."""
        if len(symbols) < 2:
            return symbols
        while True:
            best_rank, best_i = None, None
            for i in range(len(symbols) - 1):
                r = self.merge_ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                return symbols
            symbols = (
                symbols[:best_i] + [symbols[best_i] + symbols[best_i + 1]] + symbols[best_i + 2:]
            )

    def _pretokenize(self, text: str) -> List[List[str]]:
        if self.mode == "metaspace":
            if self.add_prefix_space and not text.startswith(" "):
                text = " " + text
            text = text.replace(" ", _METASPACE)
            # split before each metaspace, keeping it attached to the word it
            # precedes (llama convention: '▁word')
            words: List[str] = []
            cur = ""
            for ch in text:
                if ch == _METASPACE and cur:
                    words.append(cur)
                    cur = ch
                else:
                    cur += ch
            if cur:
                words.append(cur)
            return [list(w) for w in words]
        # byte_level: whole text as bytes -> unicode, split on spaces keeping
        # the leading-space convention (Ġ)
        pieces: List[List[str]] = []
        for word in _split_keep_space(text):
            pieces.append([_B2U[b] for b in word.encode("utf-8")])
        return pieces

    def _symbol_ids(self, sym: str) -> List[int]:
        if sym in self.vocab:
            return [self.vocab[sym]]
        if self.byte_fallback:
            ids = []
            for b in sym.encode("utf-8"):
                tok = f"<0x{b:02X}>"
                if tok in self.vocab:
                    ids.append(self.vocab[tok])
                elif self.unk_token:
                    ids.append(self.vocab[self.unk_token])
            return ids
        if self.unk_token and self.unk_token in self.vocab:
            return [self.vocab[self.unk_token]]
        return []

    def encode(self, text: str, *, add_special: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special and "<s>" in self.special_tokens:
            ids.append(self.special_tokens["<s>"])
        for word in self._pretokenize(text):
            for sym in self._bpe_word(word):
                ids.extend(self._symbol_ids(sym))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.id_to_token.get(int(i), "") for i in ids]
        toks = [t for t in toks if t not in self.special_tokens]
        if self.mode == "metaspace":
            out = []
            for t in toks:
                if t.startswith("<0x") and t.endswith(">"):
                    out.append(chr(int(t[3:-1], 16)))  # byte fallback (lossy for multibyte)
                else:
                    out.append(t)
            return "".join(out).replace(_METASPACE, " ").lstrip(" ")
        data = bytearray()
        for t in toks:
            for ch in t:
                if ch in _U2B:
                    data.append(_U2B[ch])
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return max(max(self.vocab.values(), default=0), max(self.special_tokens.values(), default=0)) + 1

    # --- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        """Write HF-compatible tokenizer.json (subset)."""
        merges = [None] * len(self.merge_ranks)
        for pair, rank in self.merge_ranks.items():
            merges[rank] = f"{pair[0]} {pair[1]}"
        doc = {
            "version": "1.0",
            "added_tokens": [
                {"id": i, "content": t, "special": True} for t, i in sorted(self.special_tokens.items(), key=lambda kv: kv[1])
            ],
            "pre_tokenizer": (
                {"type": "Metaspace"} if self.mode == "metaspace" else {"type": "ByteLevel"}
            ),
            "model": {
                "type": "BPE",
                "unk_token": self.unk_token,
                "byte_fallback": self.byte_fallback,
                "vocab": self.vocab,
                "merges": merges,
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        """Load from tokenizer.json (file or HF checkpoint dir)."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        with open(path) as f:
            doc = json.load(f)
        model = doc["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')!r}")
        merges = []
        for m in model.get("merges", []):
            merges.append(tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m))
        mode = "byte_level"
        pre = doc.get("pre_tokenizer") or {}
        kinds = [pre.get("type")] + [p.get("type") for p in pre.get("pretokenizers", [])]
        if "Metaspace" in kinds or model.get("byte_fallback"):
            mode = "metaspace"
        special = {t["content"]: t["id"] for t in doc.get("added_tokens", []) if t.get("special")}
        return cls(
            model["vocab"],
            merges,
            mode=mode,
            byte_fallback=bool(model.get("byte_fallback")),
            unk_token=model.get("unk_token"),
            special_tokens=special,
        )


def _split_keep_space(text: str) -> List[str]:
    """'a bc' -> ['a', ' bc'] (gpt2 leading-space words)."""
    out: List[str] = []
    cur = ""
    for ch in text:
        if ch == " " and cur:
            out.append(cur)
            cur = " "
        else:
            cur += ch
    if cur:
        out.append(cur)
    return out


def train_bpe(
    corpus: Iterable[str], vocab_size: int = 512, *, special_tokens: Sequence[str] = ("<s>", "</s>", "<pad>")
) -> BPETokenizer:
    """Train a byte-level BPE from raw text (zero-egress tokenizer)."""
    floor = 256 + len(special_tokens)
    if vocab_size < floor:
        raise ValueError(
            f"byte-level BPE needs vocab_size >= {floor} (256 byte symbols + "
            f"{len(special_tokens)} specials); got {vocab_size}. Use a model "
            f"vocab of at least {floor} for real-text training."
        )
    words = Counter()
    for line in corpus:
        for w in _split_keep_space(line):
            words[tuple(_B2U[b] for b in w.encode("utf-8"))] += 1

    vocab = {u: i for i, u in enumerate(sorted(_B2U.values()))}
    merges: List[Tuple[str, str]] = []
    wordlist = [(list(w), c) for w, c in words.items()]
    while len(vocab) + len(special_tokens) < vocab_size:
        pairs: Counter = Counter()
        for syms, c in wordlist:
            for i in range(len(syms) - 1):
                pairs[(syms[i], syms[i + 1])] += c
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append((a, b))
        vocab[a + b] = len(vocab)
        for syms, _c in wordlist:
            i = 0
            while i < len(syms) - 1:
                if syms[i] == a and syms[i + 1] == b:
                    syms[i : i + 2] = [a + b]
                else:
                    i += 1
    special = {t: len(vocab) + i for i, t in enumerate(special_tokens)}
    return BPETokenizer(vocab, merges, mode="byte_level", special_tokens=special)
