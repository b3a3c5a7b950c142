"""Native C++ parser vs the Python pipeline: identical outputs.

The seeded-qa1 tests build the native library from native/ into a
temporary directory (the `native_lib` fixture); the real-text tests read
the reference's dataset and need the library built in place
(`make -C native`)."""
import os
import shutil
import subprocess

import numpy as np
import pytest

from qmann_tpu.data import load_task
from qmann_tpu.data import native
from qmann_tpu.data.native import load_task_native, native_available
from qmann_tpu.data.synth import TASK as QA1

# the reference's bAbI release (MemN2N/dataset), where present
DATASET = os.environ.get("QMANN_BABI_DATASET", "")
PARSED = os.path.join(DATASET, "en_10k_parsed")
RAW = os.path.join(DATASET, "tasks_1-20_v1-2", "en-10k")
NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

needs_native = pytest.mark.skipif(
    not (native_available() and os.path.isdir(PARSED)),
    reason="native lib or dataset missing")


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """Build native/ with its Makefile into a temporary directory and
    point the loader at the result for this module's tests."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler to build native/")
    build = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "babi_parser.cpp"):
        shutil.copy(os.path.join(NATIVE_SRC, name), build)
    subprocess.run(["make", "-s", "-C", str(build)], check=True)
    saved = native._LIB_PATH, native._lib
    native._LIB_PATH, native._lib = str(build / "libqmann_data.so"), None
    assert native_available()
    yield
    native._LIB_PATH, native._lib = saved


def _assert_same(py, nat, fields=("memory", "question", "answer", "n_sen",
                                  "answer_index")):
    assert nat.dims == py.dims
    assert nat.dictionary.words == py.dictionary.words
    for split in ("train", "valid", "test"):
        a, b = getattr(py, split), getattr(nat, split)
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{split}.{f}")


@pytest.mark.parametrize("limits", [(500, 200), (None, None)])
def test_native_matches_python_on_seeded_qa1(native_lib, qa1_dir, limits):
    kw = dict(raw_path=qa1_dir, limit_train=limits[0], limit_test=limits[1])
    _assert_same(load_task(QA1, qa1_dir, **kw),
                 load_task_native(QA1, qa1_dir, **kw))


@needs_native
@pytest.mark.parametrize("task,use_raw", [
    ("qa1_single-supporting-fact", False),
    ("qa1_single-supporting-fact", True),
    ("qa2_two-supporting-facts", True),   # parsed train set missing
    ("qa7_counting", False),
])
def test_native_matches_python(task, use_raw):
    py = load_task(task, PARSED, raw_path=RAW, use_raw=use_raw,
                   limit_train=500, limit_test=200)
    nat = load_task_native(task, PARSED, raw_path=RAW, use_raw=use_raw,
                           limit_train=500, limit_test=200)
    assert nat.dims == py.dims
    assert nat.dictionary.words == py.dictionary.words
    for split in ("train", "valid", "test"):
        a, b = getattr(py, split), getattr(nat, split)
        np.testing.assert_array_equal(a.memory, b.memory, err_msg=split)
        np.testing.assert_array_equal(a.question, b.question)
        np.testing.assert_array_equal(a.answer, b.answer)
        np.testing.assert_array_equal(a.n_sen, b.n_sen)
        np.testing.assert_array_equal(a.answer_index, b.answer_index)


def test_native_full_task_shapes(native_lib, qa1_dir):
    nat = load_task_native(QA1, qa1_dir, raw_path=qa1_dir)
    assert len(nat.train) == 9000 and len(nat.valid) == 1000
    assert len(nat.test) == 1000


def test_native_shuffle_split_matches_python(native_lib, qa1_dir):
    """shuffle_split permutes vectorized rows natively, raw samples in
    Python — identical arrays either way (vectorization is per-sample)."""
    py = load_task(QA1, qa1_dir, raw_path=qa1_dir,
                   limit_train=500, limit_test=100, shuffle_split=True,
                   split_seed=3)
    nat = load_task_native(QA1, qa1_dir, raw_path=qa1_dir,
                           limit_train=500, limit_test=100,
                           shuffle_split=True, split_seed=3)
    for split in ("train", "valid", "test"):
        a, b = getattr(py, split), getattr(nat, split)
        np.testing.assert_array_equal(a.memory, b.memory, err_msg=split)
        np.testing.assert_array_equal(a.question, b.question)
        np.testing.assert_array_equal(a.answer, b.answer)
        np.testing.assert_array_equal(a.answer_index, b.answer_index)


def test_native_dim_forced_matches_python(native_lib, qa1_dir):
    """DIM_FORCED (define.h:151): the native path expresses forced dims
    through its pad knobs; arrays and dims must match the Python
    compute_dims(dim_forced=True) layout."""
    kw = dict(limit_train=300, limit_test=50, dim_forced=True,
              max_dict_len=96, max_sen_len=50)
    py = load_task(QA1, qa1_dir, raw_path=qa1_dir, **kw)
    nat = load_task_native(QA1, qa1_dir, raw_path=qa1_dir, **kw)
    assert py.dims.dim_dict == 96 and py.dims.dim_input == 96 + 50
    assert nat.dims.dim_dict == py.dims.dim_dict
    assert nat.dims.dim_input == py.dims.dim_input
    assert nat.dims.max_line == py.dims.max_line
    for split in ("train", "valid", "test"):
        a, b = getattr(py, split), getattr(nat, split)
        np.testing.assert_array_equal(a.memory, b.memory, err_msg=split)
        np.testing.assert_array_equal(a.question, b.question)
        np.testing.assert_array_equal(a.answer, b.answer)
