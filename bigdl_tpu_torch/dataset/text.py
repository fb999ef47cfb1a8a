"""Text pipeline: sentence splitting and tokenisation, the dictionary and
the sentence-to-sample transforms (``bigdl_tpu/dataset/text.py``; reference
``dataset/text/``).  Tokenisation is regex-based, as in the JAX package.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class SentenceSplitter(Transformer):
    """Paragraph → sentences (reference ``SentenceSplitter``; regex-based)."""

    _pat = re.compile(r"(?<=[.!?])\s+")

    def __call__(self, it: Iterator[str]) -> Iterator[str]:
        for text in it:
            for s in self._pat.split(text):
                s = s.strip()
                if s:
                    yield s


class SentenceTokenizer(Transformer):
    """Sentence → token list (reference ``SentenceTokenizer``)."""

    _pat = re.compile(r"[A-Za-z0-9']+|[.,!?;:()\"]")

    def __call__(self, it: Iterator[str]) -> Iterator[List[str]]:
        for s in it:
            yield self._pat.findall(s.lower())


class SentenceBiPadding(Transformer):
    """Wrap each sentence in start/end markers (reference
    ``pyspark/bigdl/dataset/sentence.py`` sentences_bipadding — the rnn
    example's LM pipeline marks sentence boundaries with these tokens)."""

    START = "SENTENCESTART"
    END = "SENTENCEEND"

    def __call__(self, it: Iterator[str]) -> Iterator[str]:
        for s in it:
            yield f"{self.START} {s} {self.END}"


class Dictionary:
    """Word ↔ index vocabulary (reference ``dataset/text/Dictionary.scala``).

    Indices are 0-based; ``vocab_size`` caps to the most frequent words, the
    rest map to an out-of-vocabulary index = len(vocab) (as the reference's
    discard-and-UNK behavior).
    """

    def __init__(self, sentences: Optional[Iterable[List[str]]] = None,
                 vocab_size: Optional[int] = None):
        self.word2index: Dict[str, int] = {}
        self.index2word: Dict[int, str] = {}
        if sentences is not None:
            counts = Counter(w for s in sentences for w in s)
            ordered = [w for w, _ in counts.most_common(vocab_size)]
            for i, w in enumerate(ordered):
                self.word2index[w] = i
                self.index2word[i] = w

    def vocab_size(self) -> int:
        return len(self.word2index)

    def get_index(self, word: str) -> int:
        return self.word2index.get(word, len(self.word2index))

    def get_word(self, index: int) -> str:
        return self.index2word.get(index, "<unk>")

    def add_word(self, word: str) -> int:
        if word not in self.word2index:
            i = len(self.word2index)
            self.word2index[word] = i
            self.index2word[i] = word
        return self.word2index[word]


class LabeledSentence:
    """Token-index sequence + per-step or scalar label
    (reference ``LabeledSentence``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: Sequence[int], label):
        self.data = np.asarray(data, dtype=np.float32)
        self.label = np.asarray(label, dtype=np.float32)


class TextToLabeledSentence(Transformer):
    """Token lists → language-model pairs: data=w[0..n-2], label=w[1..n-1]
    (reference ``TextToLabeledSentence``)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, it: Iterator[List[str]]) -> Iterator[LabeledSentence]:
        for tokens in it:
            idx = [self.dictionary.get_index(w) for w in tokens]
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence → Sample, optionally one-hot and/or fixed-length padded
    (reference ``LabeledSentenceToSample``).

    ``one_hot``: emit (T, vocab) one-hot features like the reference's SimpleRNN
    pipeline; else raw index vectors (for LookupTable embedding, 1-based labels
    for ClassNLL as in the reference: label = index + 1).

    Out-of-vocabulary indices (``Dictionary.get_index`` returns
    ``vocab_size()`` for unknown words) are clamped into the last slot
    ``vocab_length - 1``, so pass ``vocab_length = dictionary.vocab_size() + 1``
    to give OOV its own column, or ``vocab_size()`` to fold it onto the rarest
    word.
    """

    def __init__(self, vocab_length: int, fixed_length: Optional[int] = None,
                 one_hot: bool = True):
        self.vocab_length = vocab_length
        self.fixed_length = fixed_length
        self.one_hot = one_hot

    def __call__(self, it: Iterator[LabeledSentence]) -> Iterator[Sample]:
        for s in it:
            n = len(s.data)
            t = self.fixed_length or n
            data_idx = np.zeros(t, dtype=np.int32)
            data_idx[:min(n, t)] = np.minimum(
                s.data[:t].astype(np.int32), self.vocab_length - 1)
            label = np.zeros(t, dtype=np.float32)
            m = min(len(s.label), t)
            label[:m] = np.minimum(s.label[:m],
                                   self.vocab_length - 1) + 1.0  # 1-based
            if self.one_hot:
                feat = np.zeros((t, self.vocab_length), dtype=np.float32)
                feat[np.arange(min(n, t)), data_idx[:min(n, t)]] = 1.0
            else:
                feat = data_idx.astype(np.float32) + 1.0  # 1-based for LookupTable
            yield Sample(feat, label)
