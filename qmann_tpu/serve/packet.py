"""The FPGA packet-stream protocol, reborn as a host-side feed protocol.

The reference streams test samples to an FPGA as 16-bit packets
{type:4, addr:12} over Xillybus character devices (packet struct
MemN2N/sample.h:29-35; types MemN2N/define.h:357-372; writer/reader
threads MemN2N/MemN2N.c:3200-3289; packet construction
MemN2N/sample.c:576-687):

  per sentence:  TYPE_*_SEN per word index, then TYPE_*_SEN_DONE carrying
                 the temporal-encoding index;
  per question:  TYPE_*_QUEST per word, the last one TYPE_*_QUEST_DONE;
  per answer:    TYPE_*_ANS per word, the last one TYPE_*_ANS_DONE;
  response:      one packet per sample whose addr is the predicted
                 answer's dictionary index (MemN2N/MemN2N.c:3273-3284).

Here the same wire format feeds the serving engine over any byte
stream (socket, pipe, file).  Packets are little-endian uint16 with the
type in the top 4 bits (TYPE_CAST_PKT16_SHORT, lib/common.h:240).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, List, Tuple

# packet types (MemN2N/define.h:360-372)
TYPE_TRAIN_SEN = 0x8
TYPE_TRAIN_SEN_DONE = 0x9
TYPE_TRAIN_QUEST = 0xA
TYPE_TRAIN_QUEST_DONE = 0xB
TYPE_TRAIN_ANS = 0xC
TYPE_TRAIN_ANS_DONE = 0xD

TYPE_TEST_SEN = 0x0
TYPE_TEST_SEN_DONE = 0x1
TYPE_TEST_QUEST = 0x2
TYPE_TEST_QUEST_DONE = 0x3
TYPE_TEST_ANS = 0x4
TYPE_TEST_ANS_DONE = 0x5

NUM_BIT_ADDR = 12  # define.h:358
ADDR_MASK = (1 << NUM_BIT_ADDR) - 1


def pack(ptype: int, addr: int) -> int:
    """TYPE_CAST_PKT16_SHORT (lib/common.h:240)."""
    return ((ptype << NUM_BIT_ADDR) & 0xF000) | (addr & ADDR_MASK)


def unpack(word: int) -> Tuple[int, int]:
    return (word >> NUM_BIT_ADDR) & 0xF, word & ADDR_MASK


@dataclasses.dataclass
class IndexedSample:
    """A sample as word-index sequences (post-dictionary, pre-BoW):
    sentences include their temporal-encoding index as the final entry
    (sample_init/sample_vectorization, MemN2N/sample.c:337-474)."""
    sentences: List[List[int]]  # each: word indices (TE index separate)
    te_indices: List[int]       # per-sentence temporal-encoding index
    question: List[int]
    answer: List[int]


def encode_sample(sample: IndexedSample, train: bool = False) -> bytes:
    """Sample -> packet byte stream (MemN2N/sample.c:583-687)."""
    sen, sen_done = ((TYPE_TRAIN_SEN, TYPE_TRAIN_SEN_DONE) if train
                     else (TYPE_TEST_SEN, TYPE_TEST_SEN_DONE))
    quest, quest_done = ((TYPE_TRAIN_QUEST, TYPE_TRAIN_QUEST_DONE) if train
                         else (TYPE_TEST_QUEST, TYPE_TEST_QUEST_DONE))
    ans, ans_done = ((TYPE_TRAIN_ANS, TYPE_TRAIN_ANS_DONE) if train
                     else (TYPE_TEST_ANS, TYPE_TEST_ANS_DONE))
    words: List[int] = []
    for s, te in zip(sample.sentences, sample.te_indices):
        for w in s:
            words.append(pack(sen, w))
        words.append(pack(sen_done, te))
    for j, w in enumerate(sample.question):
        t = quest_done if j == len(sample.question) - 1 else quest
        words.append(pack(t, w))
    for j, w in enumerate(sample.answer):
        t = ans_done if j == len(sample.answer) - 1 else ans
        words.append(pack(t, w))
    return struct.pack(f"<{len(words)}H", *words)


def write_sample_bin(samples: Iterable[IndexedSample], path: str,
                     train: bool = False) -> int:
    """EN_SAMPLE_BIN_OUT analog (MemN2N/sample.c:576-687): dump a whole
    split's packet stream to a binary file (the reference writes e.g.
    qa1_test.bin to feed the FPGA testbench).  Returns bytes written."""
    total = 0
    with open(path, "wb") as f:
        for s in samples:
            total += f.write(encode_sample(s, train=train))
    return total


def encode_response(answer_index: int) -> bytes:
    """One response packet per sample (the stream_read contract,
    MemN2N/MemN2N.c:3273-3284)."""
    return struct.pack("<H", pack(TYPE_TEST_ANS, answer_index))


def decode_response(data: bytes) -> List[int]:
    return [unpack(w)[1] for w in struct.unpack(f"<{len(data)//2}H", data)]


class PacketDecoder:
    """Incremental packet-stream -> IndexedSample decoder (the role of the
    FPGA-side front end).  Feed bytes; completed samples come out."""

    def __init__(self):
        self._buf = b""
        self._reset_sample()

    def _reset_sample(self):
        self._sentences: List[List[int]] = []
        self._te: List[int] = []
        self._cur_sentence: List[int] = []
        self._question: List[int] = []
        self._answer: List[int] = []

    def feed(self, data: bytes) -> List[IndexedSample]:
        self._buf += data
        out: List[IndexedSample] = []
        n = len(self._buf) // 2
        words = struct.unpack(f"<{n}H", self._buf[:2 * n])
        self._buf = self._buf[2 * n:]
        for w in words:
            ptype, addr = unpack(w)
            base = ptype & 0x7  # train types are test types | 0x8
            if base == TYPE_TEST_SEN:
                self._cur_sentence.append(addr)
            elif base == TYPE_TEST_SEN_DONE:
                self._sentences.append(self._cur_sentence)
                self._te.append(addr)
                self._cur_sentence = []
            elif base == TYPE_TEST_QUEST:
                self._question.append(addr)
            elif base == TYPE_TEST_QUEST_DONE:
                self._question.append(addr)
            elif base == TYPE_TEST_ANS:
                self._answer.append(addr)
            elif base == TYPE_TEST_ANS_DONE:
                self._answer.append(addr)
                out.append(IndexedSample(self._sentences, self._te,
                                         self._question, self._answer))
                self._reset_sample()
        return out
