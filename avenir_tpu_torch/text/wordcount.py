"""Word counting — host tokenization + device aggregation; port of
``avenir_tpu/text/wordcount.py``.

The counterpart of text/WordCounter.java: mapper tokenizes (:117-128) and
emits word→1, reducer sums. Here tokenization builds a vocabulary on the host
(the open-vocab pass the reference gets from the shuffle's string keys), and
each batch is counted by ``torch.bincount`` on the counter's device; the
totals add up in int64 on the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from avenir_tpu_torch.device import resolve_device
from avenir_tpu_torch.text.analyzer import tokenize


class WordCount:
    """Streaming word counter with a growing vocabulary.  ``device`` is
    ``cuda`` unless the caller asks for ``cpu``."""

    def __init__(self, stopwords: bool = True, stem: bool = False, device=None):
        self.stopwords = stopwords
        self.stem = stem
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.counts = np.zeros(0, np.int64)

    def _encode(self, tokens: List[str]) -> np.ndarray:
        codes = np.empty(len(tokens), np.int64)
        vocab = self.vocab
        for i, t in enumerate(tokens):
            code = vocab.get(t)
            if code is None:
                code = len(vocab)
                vocab[t] = code
            codes[i] = code
        return codes

    def add_lines(self, lines: Iterable[str]) -> None:
        tokens: List[str] = []
        for ln in lines:
            tokens.extend(tokenize(ln, stopwords=self.stopwords, stem=self.stem))
        if not tokens:
            return
        codes = self._encode(tokens)
        v = len(self.vocab)
        batch = torch.bincount(torch.from_numpy(codes).to(self.device),
                               minlength=v).cpu().numpy()
        if self.counts.shape[0] < v:
            self.counts = np.concatenate(
                [self.counts, np.zeros(v - self.counts.shape[0], np.int64)])
        self.counts += batch.astype(np.int64)

    def items(self) -> List[Tuple[str, int]]:
        inv = {i: w for w, i in self.vocab.items()}
        return [(inv[i], int(self.counts[i])) for i in range(len(self.vocab))]

    def top(self, k: int = 20) -> List[Tuple[str, int]]:
        return sorted(self.items(), key=lambda t: (-t[1], t[0]))[:k]

    def to_lines(self, delim: str = ",", sort: bool = True) -> List[str]:
        items = (sorted(self.items(), key=lambda t: (-t[1], t[0]))
                 if sort else sorted(self.items()))
        return [f"{w}{delim}{c}" for w, c in items]
