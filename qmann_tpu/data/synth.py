r"""Seeded generator of bAbI task 1 ("single supporting fact") data.

Written from the published task description (Weston et al., "Towards
AI-Complete Question Answering: A Set of Prerequisite Toy Tasks",
arXiv:1502.05698, task 1): actors move between locations, and each
question asks where one actor is; the answer is the location of that
actor's most recent move, which is the single supporting fact.

The files use the raw bAbI text format of the en-10k release, so both
loaders (data.babi and data.native) read them unchanged through
data.babi.resolve_task_file:

    1 Mary moved to the bathroom.
    2 John went to the hallway.
    3 Where is Mary? \tbathroom\t1

Each story holds five blocks of two statements and one question (10
memory sentences, as in the released qa1); the train split holds 10,000
questions and the test split 1,000, the en-10k sizes.  The vocabulary is
the released task's: 4 actors, 6 locations, 5 motion phrases, so the
vectorized dims match the reference's qa1 (dim_dict 20, max_line 10).

    python -m qmann_tpu.data.synth [--seed 0] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np

TASK = "qa1_single-supporting-fact"
ACTORS = ("Mary", "John", "Daniel", "Sandra")
LOCATIONS = ("bathroom", "bedroom", "garden", "hallway", "kitchen", "office")
MOVES = ("moved to", "went to", "went back to", "journeyed to",
         "travelled to")
STATEMENTS_PER_QUESTION = 2
QUESTIONS_PER_STORY = 5
N_TRAIN = 10_000
N_TEST = 1_000

# generated files live inside the checkout (listed in .gitignore)
DATA_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".babi_synth")


def qa1_dir(seed: int = 0) -> str:
    """The fixed directory that holds the qa1 files for `seed`."""
    return os.path.join(DATA_ROOT, f"seed{seed}")


def qa1_lines(rng: np.random.Generator, n_questions: int) -> List[str]:
    """Raw bAbI lines for stories holding `n_questions` questions in all."""
    lines: List[str] = []
    asked = 0
    while asked < n_questions:
        where = {}                      # actor -> (location, line id)
        line_id = 0
        for _ in range(min(QUESTIONS_PER_STORY, n_questions - asked)):
            for _ in range(STATEMENTS_PER_QUESTION):
                actor = ACTORS[rng.integers(len(ACTORS))]
                # a move always changes the actor's location
                here = where.get(actor, (None, 0))[0]
                options = [loc for loc in LOCATIONS if loc != here]
                loc = options[rng.integers(len(options))]
                move = MOVES[rng.integers(len(MOVES))]
                line_id += 1
                where[actor] = (loc, line_id)
                lines.append(f"{line_id} {actor} {move} the {loc}.")
            # ask about an actor the story has placed
            placed = sorted(where)
            actor = placed[rng.integers(len(placed))]
            loc, support = where[actor]
            line_id += 1
            lines.append(f"{line_id} Where is {actor}? \t{loc}\t{support}")
            asked += 1
    return lines


def write_qa1(out_dir: str, seed: int = 0, n_train: int = N_TRAIN,
              n_test: int = N_TEST) -> str:
    """Write qa1's train and test files for `seed` into out_dir.

    Each split draws from its own stream of the seed, so the test split
    does not depend on the train size.  Files are replaced atomically:
    concurrent writers of the same seed write the same bytes."""
    os.makedirs(out_dir, exist_ok=True)
    for split_id, (split, n) in enumerate((("train", n_train),
                                           ("test", n_test))):
        rng = np.random.default_rng([seed, split_id])
        text = "\n".join(qa1_lines(rng, n)) + "\n"
        fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f".{split}.")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(out_dir, f"{TASK}_{split}.txt"))
    return out_dir


def ensure_qa1(seed: int = 0) -> str:
    """qa1_dir(seed), with the files written first if either is missing."""
    out = qa1_dir(seed)
    if not all(os.path.exists(os.path.join(out, f"{TASK}_{split}.txt"))
               for split in ("train", "test")):
        write_qa1(out, seed)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.data.synth",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="output directory (default: the seed's fixed "
                        "directory inside the checkout)")
    args = p.parse_args(argv)
    print(write_qa1(args.out or qa1_dir(args.seed), args.seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
