"""The seeded qa1 generator (qmann_tpu.data.synth): deterministic per
seed, the bAbI task-1 rule, the released file format and sizes."""
import re

import numpy as np
import pytest

from qmann_tpu.data import load_task, parse_raw_file
from qmann_tpu.data.synth import (
    ACTORS, LOCATIONS, TASK, main, qa1_dir, write_qa1,
)

_STATEMENT = re.compile(r"^(\d+) (\w+) (?:moved|went|went back|journeyed|"
                        r"travelled) to the (\w+)\.$")
_QUESTION = re.compile(r"^(\d+) Where is (\w+)\? \t(\w+)\t(\d+)$")


def _read(d, split):
    with open(f"{d}/{TASK}_{split}.txt") as f:
        return f.read()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return write_qa1(str(tmp_path_factory.mktemp("qa1")), seed=0,
                     n_train=500, n_test=100)


@pytest.mark.parametrize("split", ["train", "test"])
def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path, small, split):
    again = write_qa1(str(tmp_path / "again"), seed=0, n_train=500,
                      n_test=100)
    other = write_qa1(str(tmp_path / "other"), seed=1, n_train=500,
                      n_test=100)
    assert _read(again, split) == _read(small, split)
    assert _read(other, split) != _read(small, split)


def test_test_split_independent_of_train_size(tmp_path, small):
    bigger = write_qa1(str(tmp_path / "b"), seed=0, n_train=700, n_test=100)
    assert _read(bigger, "test") == _read(small, "test")


@pytest.mark.parametrize("split", ["train", "test"])
def test_answers_follow_the_task1_rule(small, split):
    """Replay every story: the answer is the asked actor's location at
    their most recent move, and the supporting-fact id names that move."""
    n_questions = 0
    for line in _read(small, split).splitlines():
        if line.startswith("1 "):
            where, stated = {}, {}
        m = _STATEMENT.match(line)
        if m:
            nid, actor, loc = m.groups()
            assert actor in ACTORS and loc in LOCATIONS
            assert where.get(actor) != loc      # a move changes location
            where[actor] = loc
            stated[int(nid)] = (actor, loc)
            continue
        m = _QUESTION.match(line)
        assert m, line
        _, actor, answer, support = m.groups()
        assert answer == where[actor]
        assert stated[int(support)] == (actor, answer)
        # no later statement moves the actor again
        assert max(i for i, (a, _) in stated.items() if a == actor) \
            == int(support)
        n_questions += 1
    assert n_questions == {"train": 500, "test": 100}[split]


def test_stories_hold_ten_statements_and_five_questions(small):
    samples = parse_raw_file(f"{small}/{TASK}_train.txt")
    assert len(samples) == 500
    # question k of a story sees the 2k statements before it
    assert [len(s.sentences) for s in samples[:5]] == [2, 4, 6, 8, 10]
    assert max(len(s.sentences) for s in samples) == 10


def test_full_size_loads_at_reference_dims(qa1_dir):
    td = load_task(TASK, qa1_dir)
    assert (len(td.train), len(td.valid), len(td.test)) == (9000, 1000, 1000)
    assert td.dims.dim_dict == 20 and td.dims.max_line == 10
    assert td.dims.dim_input == 30
    # every test answer is a location word of the train dictionary
    words = [td.dictionary.words[i] for i in td.test.answer_index]
    assert set(words) <= set(LOCATIONS)
    assert (td.test.answer.sum(axis=1) == 1).all()
    # answers are not degenerate: every location is asked for
    assert len(np.unique(td.test.answer_index)) == len(LOCATIONS)


def test_cli_writes_to_the_seed_directory(tmp_path, capsys):
    assert main(["--seed", "3", "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path)
    assert len(parse_raw_file(f"{tmp_path}/{TASK}_test.txt")) == 1000
    assert qa1_dir(3).endswith("seed3")
