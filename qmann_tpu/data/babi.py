"""bAbI data pipeline.

Replaces the reference's three-stage pipeline with one module:
  1. offline Keras/python2 tokenizer  (MemN2N/dataset/parser.py:16-66)
  2. custom-format parser             (MemN2N/sample.c:87-249)
  3. vectorizer (word->index, temporal encoding, bag-of-words)
                                      (MemN2N/sample.c:337-574)

Both input formats are supported:
  * the reference's parsed '+NS+/+I+/+S+/+Q+/+A+' files
    (en_10k_parsed/...), and
  * the raw bAbI tasks_1-20_v1-2 text (tokenization folded in from
    parser.py: split on non-word keeping punctuation, drop the trailing
    '.' of statements and the trailing token — the '?' — of questions).
The two paths yield identical samples (tested in tests/test_data.py).

Deviation (documented, behavior-preserving): the reference stages
variable-length per-sample sentence arrays; here stories are padded to a
static memory length with a validity mask, and all quantized ops /
softmaxes mask padded rows (SURVEY.md section 7, hard part 4).

An optional C++ parser (native/babi_parser.cpp) provides the same
parsing via ctypes for large corpora; this module transparently falls
back to pure Python.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    sentences: List[List[str]]   # most recent `max_sen_len` sentences
    question: List[str]
    answer: List[str]


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def _tokenize(sent: str) -> List[str]:
    """parser.py:16-22: split including punctuation as separate tokens."""
    return [x.strip() for x in re.split(r"(\W+)", sent) if x.strip()]


def parse_parsed_file(path: str, max_sen_len: int = 50,
                      limit: Optional[int] = None) -> List[Sample]:
    """Parse the '+NS+' custom format (MemN2N/sample.c:87-249), keeping
    only the most recent `max_sen_len` sentences per story
    (sample_constructor truncation, sample.c:152-166)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i = 0
    # skip blank, +NS+, count (sample.c:119-121)
    while lines[i].strip() != "+NS+":
        i += 1
    n_samples = int(lines[i + 1])
    if limit is not None:
        n_samples = min(n_samples, limit)
    i += 2
    samples: List[Sample] = []
    while len(samples) < n_samples and i < len(lines):
        while i < len(lines) and lines[i].strip() != "+I+":
            i += 1
        if i >= len(lines):
            break
        i += 2  # +I+, index
        assert lines[i].strip() == "+S+"
        n_sen_ori = int(lines[i + 1])
        i += 2
        sents = []
        for k in range(n_sen_ori):
            sents.append(_split_words(lines[i]))
            i += 1
        if n_sen_ori > max_sen_len:
            sents = sents[n_sen_ori - max_sen_len:]
        assert lines[i].strip() == "+Q+"
        question = _split_words(lines[i + 1])
        i += 2
        assert lines[i].strip() == "+A+"
        answer = _split_words(lines[i + 1])
        i += 2
        samples.append(Sample(sents, question, answer))
    return samples


def _split_words(line: str) -> List[str]:
    """strtok(line, " ") semantics (sample.c:180-196)."""
    return [w for w in line.strip().split(" ") if w]


def parse_raw_file(path: str, max_sen_len: int = 50,
                   limit: Optional[int] = None) -> List[Sample]:
    """Parse raw bAbI task text directly (folding in parser.py's
    parse_stories + the parsed-format writer's transformations:
    statements lose their trailing '.', questions lose their final token)."""
    samples: List[Sample] = []
    story: List[List[str]] = []
    with open(path, "r") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            nid_str, rest = raw.split(" ", 1)
            if int(nid_str) == 1:
                story = []
            if "\t" in rest:
                fields = rest.split("\t")
                q, a = fields[0], fields[1]  # supporting-fact field optional
                q_tokens = _tokenize(q)[:-1]       # drop trailing '?'
                substory = [s for s in story if s]
                if len(substory) > max_sen_len:
                    substory = substory[len(substory) - max_sen_len:]
                samples.append(Sample([list(s) for s in substory],
                                      list(q_tokens), [a.strip()]))
                story.append([])
                if limit is not None and len(samples) >= limit:
                    break
            else:
                tokens = _tokenize(rest)
                if tokens and tokens[-1] == ".":
                    tokens = tokens[:-1]           # writer drops the period
                story.append(tokens)
    return samples


# ---------------------------------------------------------------------------
# Dictionary (MemN2N/sample.c:849-931)
# ---------------------------------------------------------------------------

class Dictionary:
    """Insertion-ordered, case-insensitive vocabulary; index 0 is the NULL
    word (dictionary_constructor, sample.c:849-931)."""

    def __init__(self, null_char: str = "NULL"):
        self.words: List[str] = [null_char]
        self._index = {null_char.lower(): 0}

    def add(self, word: str) -> int:
        key = word.lower()
        idx = self._index.get(key)
        if idx is None:
            idx = len(self.words)
            self.words.append(word)
            self._index[key] = idx
        return idx

    def lookup(self, word: str) -> int:
        """word_idx (sample.c:835-847): -1 when missing (the reference
        prints 'NO WORD IN DICT')."""
        return self._index.get(word.lower(), -1)

    def __len__(self):
        return len(self.words)

    @classmethod
    def build(cls, samples: Sequence[Sample], null_char: str = "NULL"):
        """Scan order matches the reference: per sample — sentences, then
        question, then answer (sample.c:860-929)."""
        d = cls(null_char)
        for s in samples:
            for sent in s.sentences:
                for w in sent:
                    d.add(w)
            for w in s.question:
                d.add(w)
            for w in s.answer:
                d.add(w)
        return d


# ---------------------------------------------------------------------------
# Dimension computation (MemN2N/MemN2N.c:544-582)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataDims:
    dim_dict: int
    max_line: int    # max sentences per (train) story, post-truncation
    max_word: int    # max words per (train) sentence
    dim_word: int    # max_word + 1 with temporal encoding
    dim_input: int   # dim_dict + max_line with temporal encoding


def compute_dims(train_samples: Sequence[Sample], dictionary: Dictionary,
                 enable_time: bool = True, dim_forced: bool = False,
                 max_dict_len: int = 64, max_sen_len: int = 50,
                 max_line_len: int = 7, pad_dict: int = 0,
                 pad_line: int = 0) -> DataDims:
    """Dims from the TRAIN split only (MemN2N/MemN2N.c:544-582).

    pad_dict/pad_line: optional uniform-layout padding (the DIM_FORCED idea,
    define.h:151) so one compiled program serves every task; vocabulary
    indices stay below the actual dictionary size and the padded columns
    are always zero."""
    if dim_forced:
        # the 'data fits the forced dims' assumption is load-bearing
        # (out-of-range word indices would vectorize past dim_dict); the
        # reference asserts the same via its fixed-size arrays — fail
        # loudly instead of diverging (ADVICE r4)
        if len(dictionary) > max_dict_len:
            raise ValueError(
                f"dim_forced: dictionary size {len(dictionary)} exceeds "
                f"max_dict_len {max_dict_len}")
        actual_line = max((len(s.sentences) for s in train_samples),
                          default=0)
        if actual_line > max_sen_len:
            raise ValueError(
                f"dim_forced: max sentences/story {actual_line} exceeds "
                f"max_sen_len {max_sen_len}")
        dim_dict = max_dict_len
        max_word = max_line_len
        max_line = max_sen_len
        dim_input = max_dict_len + max_sen_len
        dim_word = max_word + 1 if enable_time else max_word
        return DataDims(dim_dict, max_line, max_word, dim_word, dim_input)
    max_line = max((len(s.sentences) for s in train_samples), default=0)
    max_word = max((len(sent) for s in train_samples for sent in s.sentences),
                   default=0)
    dim_dict = max(len(dictionary), pad_dict)
    max_line = max(max_line, pad_line)
    dim_input = dim_dict + max_line if enable_time else dim_dict
    dim_word = max_word + 1 if enable_time else max_word
    return DataDims(dim_dict, max_line, max_word, dim_word, dim_input)


# ---------------------------------------------------------------------------
# Vectorization (MemN2N/sample.c:413-574)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VectorizedSplit:
    """Padded, batched arrays for one data split."""
    memory: np.ndarray    # [N, max_line, dim_input] f32 bag-of-words rows
    question: np.ndarray  # [N, dim_input] f32 bag-of-words
    answer: np.ndarray    # [N, dim_input] f32 one/multi-hot
    n_sen: np.ndarray     # [N] int32 live sentence counts
    answer_index: np.ndarray  # [N] int32 first answer word index

    def __len__(self):
        return self.memory.shape[0]

    @property
    def mask(self) -> np.ndarray:
        """[N, max_line] bool validity mask for the padded memory rows."""
        return (np.arange(self.memory.shape[1])[None, :]
                < self.n_sen[:, None])


def position_encoding_weights(dims: DataDims) -> np.ndarray:
    """PE weight table 1 + 4*(i/dim_input - 0.5)*(j/dim_word - 0.5)
    (MemN2N/MemN2N.c:606-617).  EN_PE is off by default (define.h:298) and
    the reference applies it only to the question vector
    (sample.c:545-551); the sentence path is commented out."""
    i = np.arange(dims.dim_input)[:, None] / dims.dim_input - 0.5
    j = np.arange(dims.dim_word)[None, :] / dims.dim_word - 0.5
    return (1.0 + 4.0 * i * j).astype(np.float32)


def vectorize(samples: Sequence[Sample], dictionary: Dictionary,
              dims: DataDims, enable_time: bool = True,
              rand_noise_time: float = 0.0, is_train: bool = False,
              rng: Optional[np.random.Generator] = None,
              max_sen_len: int = 50, en_pe: bool = False) -> VectorizedSplit:
    """sample_vectorization (MemN2N/sample.c:413-574):
      * word -> index (case-insensitive);
      * temporal-encoding token per sentence j: index
        dim_dict + n_sen - j - 1 (:474) — the oldest sentence gets the
        largest time index;
      * optional random time noise during training (:425-464);
      * index -> bag-of-words COUNT vectors; the TE slot is SET to 1.0
        (:556), question/answer slots are incremented (:561-571).
    """
    n = len(samples)
    mem = np.zeros((n, dims.max_line, dims.dim_input), np.float32)
    que = np.zeros((n, dims.dim_input), np.float32)
    ans = np.zeros((n, dims.dim_input), np.float32)
    n_sen = np.zeros(n, np.int32)
    ans_idx = np.zeros(n, np.int32)
    use_noise = is_train and rand_noise_time != 0.0
    if use_noise and rng is None:
        rng = np.random.default_rng(0)
    pe_w = position_encoding_weights(dims) if en_pe else None

    for si, s in enumerate(samples):
        # test/valid stories can exceed the TRAIN-derived max_line; the
        # reference truncates every split to it, keeping the most recent
        # sentences (sample_constructor(&path_test, max_line, ...),
        # MemN2N/MemN2N.c:585 with max_line from the train scan :544-551)
        sentences = s.sentences[-dims.max_line:] \
            if len(s.sentences) > dims.max_line else s.sentences
        ns = len(sentences)
        n_sen[si] = ns
        if use_noise:
            n_noise = int(rng.integers(0, int(ns * rand_noise_time) + 1))
            arr_te = rng.permutation(ns + n_noise)
            # the reference clamps to MAX_SEN_LEN-1 (sample.c:445-449); we
            # additionally clamp to the actual time-slot count max_line so
            # the padded layout stays in bounds (the reference would write
            # past dim_input here — out-of-bounds in C — but noise is off
            # by default, RAND_NOISE_TIME=0.0 define.h:214)
            arr_te = np.minimum(arr_te, min(max_sen_len, dims.max_line) - 1)
            arr_te.sort()
        for j, sent in enumerate(sentences):
            n_keep = min(len(sent), dims.dim_word - 1) if enable_time \
                else min(len(sent), dims.dim_word)
            for w in sent[:n_keep]:
                idx = dictionary.lookup(w)
                if idx >= 0:
                    mem[si, j, idx] += 1.0
            if enable_time:
                if use_noise:
                    te = dims.dim_dict + int(arr_te[ns + n_noise - j - 1])
                else:
                    te = dims.dim_dict + ns - j - 1
                mem[si, j, te] = 1.0
        n_q = min(len(s.question), dims.dim_word - 1) if enable_time \
            else min(len(s.question), dims.dim_word)
        for jq, w in enumerate(s.question[:n_q]):
            idx = dictionary.lookup(w)
            if idx >= 0:
                if pe_w is not None:
                    # EN_PE: position-encoding weight REPLACES the count
                    # (sample.c:546-547 uses '=' not '+=')
                    que[si, idx] = pe_w[idx, jq]
                else:
                    que[si, idx] += 1.0
        n_a = min(len(s.answer), dims.dim_word - 1) if enable_time \
            else min(len(s.answer), dims.dim_word)
        first = True
        for w in s.answer[:n_a]:
            idx = dictionary.lookup(w)
            if idx >= 0:
                ans[si, idx] += 1.0
                if first:
                    ans_idx[si] = idx
                    first = False
    return VectorizedSplit(mem, que, ans, n_sen, ans_idx)


# ---------------------------------------------------------------------------
# Task loading (paths per define.h:322-348; split per MemN2N.c:714-717)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskData:
    train: VectorizedSplit
    valid: VectorizedSplit
    test: VectorizedSplit
    dims: DataDims
    dictionary: Dictionary


def load_task(task_name: str, data_path: str, *, use_raw: bool = False,
              raw_path: Optional[str] = None, enable_time: bool = True,
              max_sen_len: int = 50, rate_valid: float = 0.1,
              rand_noise_time: float = 0.0,
              limit_train: Optional[int] = None,
              limit_test: Optional[int] = None,
              rng: Optional[np.random.Generator] = None,
              dim_forced: bool = False, max_dict_len: int = 64,
              pad_dict: int = 0, pad_line: int = 0,
              en_pe: bool = False,
              train_task_name: Optional[str] = None,
              shuffle_split: bool = False,
              split_seed: int = 0) -> TaskData:
    """Load one bAbI task end to end.

    The validation split is the LAST rate_valid fraction of the train file
    in file order (MemN2N/MemN2N.c:636-637, :1866-1869 — shuffle is off by
    default, EN_SAMPLE_SHUFFLED=false define.h:172).  With
    shuffle_split=True the reference's EN_SAMPLE_SHUFFLED semantics apply:
    ALL train-file samples are permuted ONCE up front and the valid split
    is the TAIL of that permutation (MemN2N.c:1046-1052 builds the global
    ind_sample_shuffled; :1868 takes valid indices from its tail) — i.e. a
    random 10%, not the last 10% in file order.  This matters for
    EN_JOINT, whose qa_joint train file is the task-ordered concatenation
    of tasks 1-20 (dataset/.../qa_joint_gen.scr): without the shuffle the
    entire validation set comes from qa19/qa20, which is why the
    reference's joint config block sets EN_SAMPLE_SHUFFLED true
    (define.h:177-191).

    train_task_name: for joint mode (EN_JOINT) training reads qa_joint
    while testing reads the per-task file (MemN2N.c:520-533).
    """
    tt = train_task_name or task_name
    train_samples = load_samples(tt, "train", data_path, raw_path=raw_path,
                                 use_raw=use_raw, max_sen_len=max_sen_len,
                                 limit=limit_train)
    test_samples = load_samples(task_name, "test", data_path,
                                raw_path=raw_path, use_raw=use_raw,
                                max_sen_len=max_sen_len, limit=limit_test)

    dictionary = Dictionary.build(train_samples)
    dims = compute_dims(train_samples, dictionary, enable_time,
                        dim_forced=dim_forced, max_dict_len=max_dict_len,
                        max_sen_len=max_sen_len, pad_dict=pad_dict,
                        pad_line=pad_line)

    if shuffle_split:
        # permute AFTER Dictionary.build/compute_dims: the reference
        # builds the dictionary in file order and only then shuffles
        # sample indices (MemN2N.c: sample_init precedes rand_perm)
        perm = np.random.default_rng(split_seed).permutation(
            len(train_samples))
        train_samples = [train_samples[i] for i in perm]
    n_valid = int(len(train_samples) * rate_valid)
    n_train = len(train_samples) - n_valid
    tr = vectorize(train_samples[:n_train], dictionary, dims, enable_time,
                   rand_noise_time, is_train=True, rng=rng,
                   max_sen_len=max_sen_len, en_pe=en_pe)
    va = vectorize(train_samples[n_train:], dictionary, dims, enable_time,
                   en_pe=en_pe)
    te = vectorize(test_samples, dictionary, dims, enable_time, en_pe=en_pe)
    return TaskData(tr, va, te, dims, dictionary)


def resolve_task_file(name: str, split: str, data_path: str, *,
                      raw_path: Optional[str] = None,
                      use_raw: bool = False):
    """Single source of truth for the data fallback chain
    (parsed -> raw 10k -> sibling raw 1k 'en'); returns
    (path, is_raw) or None.  Shared by the Python and native loaders."""
    parsed_path = os.path.join(data_path, f"{name}_{split}_set")
    if not use_raw and os.path.exists(parsed_path):
        return parsed_path, False
    base = raw_path or data_path
    candidates = [os.path.join(base, f"{name}_{split}.txt")]
    if os.path.basename(base) != "en":
        candidates.append(os.path.join(os.path.dirname(base), "en",
                                       f"{name}_{split}.txt"))
    for cand in candidates:
        if os.path.exists(cand):
            return cand, True
    return None


def load_samples(name: str, split: str, data_path: str, *,
                 raw_path: Optional[str] = None, use_raw: bool = False,
                 max_sen_len: int = 50,
                 limit: Optional[int] = None) -> List[Sample]:
    """Resolve and parse one task split.

    Prefers the parsed format; falls back to raw bAbI text when the parsed
    file is absent (the reference dataset ships with several parsed train
    sets missing, e.g. qa2/qa3/qa5) — the two parsers produce identical
    samples (tests/test_data.py).  A further fallback to the sibling 1k
    'en' directory covers qa3, whose 10k raw train file is also absent.

    qa_joint (EN_JOINT, define.h:152): the 1k 'en' directory ships the
    real qa_joint files; if no joint file exists anywhere, the set is
    synthesized by concatenating tasks 1-20 in task order."""
    resolved = resolve_task_file(name, split, data_path, raw_path=raw_path,
                                 use_raw=use_raw)
    if resolved is not None:
        path, is_raw = resolved
        parse = parse_raw_file if is_raw else parse_parsed_file
        return parse(path, max_sen_len, limit)
    if name == "qa_joint":
        from qmann_tpu.config import BABI_TASKS
        joint: List[Sample] = []
        per_task = None if limit is None else max(1, limit // 20)
        for t in BABI_TASKS[:20]:
            joint.extend(load_samples(t, split, data_path, raw_path=raw_path,
                                      use_raw=use_raw,
                                      max_sen_len=max_sen_len,
                                      limit=per_task))
        return joint if limit is None else joint[:limit]
    raise FileNotFoundError(
        f"no parsed or raw data for task {name} ({split}) under "
        f"{data_path} / {raw_path}")


def load_test_split(task_name: str, data_path: str, dictionary: Dictionary,
                    dims: DataDims, *, raw_path: Optional[str] = None,
                    use_raw: bool = False, enable_time: bool = True,
                    max_sen_len: int = 50,
                    limit_test: Optional[int] = None,
                    en_pe: bool = False) -> VectorizedSplit:
    """Vectorize one task's TEST split against an existing (e.g. joint)
    dictionary and dims — the EN_JOINT flow trains once on qa_joint and
    tests every task with that model (MemN2N/MemN2N.c:520-533,
    :2241-2244)."""
    samples = load_samples(task_name, "test", data_path, raw_path=raw_path,
                           use_raw=use_raw, max_sen_len=max_sen_len,
                           limit=limit_test)
    return vectorize(samples, dictionary, dims, enable_time, en_pe=en_pe)
