"""ctypes binding for the native C++ bAbI parser/vectorizer
(native/babi_parser.cpp -> libqmann_data.so).

`load_task_native` mirrors data.babi.load_task but runs the parse +
dictionary + vectorization in C++ — the analog of the
reference's C data layer (MemN2N/sample.c).  Falls back to the Python
pipeline transparently when the shared library has not been built
(`make -C native`); tests/test_native.py asserts the two paths produce
identical arrays.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from qmann_tpu.data.babi import (
    DataDims, Dictionary, TaskData, VectorizedSplit, load_task,
    resolve_task_file,
)

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libqmann_data.so")

_lib = None


def native_available() -> bool:
    return _load_lib() is not None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.qm_load.restype = ctypes.c_void_p
    lib.qm_load.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    lib.qm_free.argtypes = [ctypes.c_void_p]
    for name in ("qm_dim_dict", "qm_max_line", "qm_max_word", "qm_dim_word",
                 "qm_dim_input", "qm_num_train", "qm_num_test",
                 "qm_dict_size"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.qm_dict_word.restype = ctypes.c_char_p
    lib.qm_dict_word.argtypes = [ctypes.c_void_p, ctypes.c_int]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.qm_fill.restype = None
    lib.qm_fill.argtypes = [ctypes.c_void_p, ctypes.c_int, f32p, f32p, f32p,
                            i32p, i32p]
    _lib = lib
    return lib


def _resolve_files(task_name: str, data_path: str, raw_path: Optional[str],
                   use_raw: bool, split: str, train_task: str):
    name = train_task if split == "train" else task_name
    resolved = resolve_task_file(name, split, data_path, raw_path=raw_path,
                                 use_raw=use_raw)
    if resolved is None:
        raise FileNotFoundError(f"no data for {name} {split}")
    return resolved


def load_task_native(task_name: str, data_path: str, *,
                     use_raw: bool = False, raw_path: Optional[str] = None,
                     enable_time: bool = True, max_sen_len: int = 50,
                     rate_valid: float = 0.1,
                     limit_train: Optional[int] = None,
                     limit_test: Optional[int] = None,
                     pad_dict: int = 0, pad_line: int = 0,
                     train_task_name: Optional[str] = None,
                     shuffle_split: bool = False, split_seed: int = 0,
                     dim_forced: bool = False, max_dict_len: int = 64,
                     **py_kwargs) -> TaskData:
    lib = _load_lib()
    if dim_forced:
        # DIM_FORCED (define.h:151): the native lib expresses forced dims
        # through its pad knobs — pad-to-at-least equals force-to when the
        # data fits the forced sizes (the reference asserts the same).
        pad_dict = max(pad_dict, max_dict_len)
        pad_line = max(pad_line, max_sen_len)
    # features only the Python vectorizer implements (noise augmentation,
    # position encoding) force the fallback rather than being dropped
    needs_python = (py_kwargs.get("rand_noise_time", 0.0) != 0.0
                    or py_kwargs.get("en_pe", False))
    if lib is None or needs_python:
        return load_task(task_name, data_path, use_raw=use_raw,
                         raw_path=raw_path, enable_time=enable_time,
                         max_sen_len=max_sen_len, rate_valid=rate_valid,
                         limit_train=limit_train, limit_test=limit_test,
                         pad_dict=pad_dict, pad_line=pad_line,
                         train_task_name=train_task_name,
                         shuffle_split=shuffle_split, split_seed=split_seed,
                         dim_forced=dim_forced, max_dict_len=max_dict_len,
                         **py_kwargs)
    tt = train_task_name or task_name
    try:
        train_file, train_raw = _resolve_files(task_name, data_path, raw_path,
                                               use_raw, "train", tt)
        test_file, test_raw = _resolve_files(task_name, data_path, raw_path,
                                             use_raw, "test", tt)
    except FileNotFoundError:
        # e.g. qa_joint, which the Python loader synthesizes
        return load_task(task_name, data_path, use_raw=use_raw,
                         raw_path=raw_path, enable_time=enable_time,
                         max_sen_len=max_sen_len, rate_valid=rate_valid,
                         limit_train=limit_train, limit_test=limit_test,
                         pad_dict=pad_dict, pad_line=pad_line,
                         train_task_name=train_task_name,
                         shuffle_split=shuffle_split, split_seed=split_seed,
                         dim_forced=dim_forced, max_dict_len=max_dict_len,
                         **py_kwargs)
    h = lib.qm_load(train_file.encode(), int(train_raw), test_file.encode(),
                    int(test_raw), max_sen_len, int(enable_time),
                    -1 if limit_train is None else limit_train,
                    -1 if limit_test is None else limit_test,
                    pad_dict, pad_line)
    if not h:
        raise RuntimeError(f"native parser failed for {train_file}")
    try:
        dims = DataDims(dim_dict=lib.qm_dim_dict(h),
                        max_line=lib.qm_max_line(h),
                        max_word=lib.qm_max_word(h),
                        dim_word=lib.qm_dim_word(h),
                        dim_input=lib.qm_dim_input(h))
        if dim_forced and (dims.dim_dict != max_dict_len
                           or dims.max_line != max_sen_len):
            # pad-to-at-least only equals force-to while the data fits;
            # past that the native and Python loaders would silently
            # diverge (the Python loader hard-forces and would vectorize
            # out-of-range indices) — fail loudly instead (ADVICE r4)
            raise ValueError(
                f"dim_forced: data exceeds forced dims "
                f"(dict {dims.dim_dict} vs {max_dict_len}, "
                f"lines {dims.max_line} vs {max_sen_len})")
        dictionary = Dictionary()
        for i in range(1, lib.qm_dict_size(h)):
            dictionary.add(lib.qm_dict_word(h, i).decode())

        def fetch(split_id: int, n: int) -> VectorizedSplit:
            mem = np.zeros((n, dims.max_line, dims.dim_input), np.float32)
            que = np.zeros((n, dims.dim_input), np.float32)
            ans = np.zeros((n, dims.dim_input), np.float32)
            n_sen = np.zeros(n, np.int32)
            aidx = np.zeros(n, np.int32)
            if n:
                lib.qm_fill(h, split_id, mem, que, ans, n_sen, aidx)
            return VectorizedSplit(mem, que, ans, n_sen, aidx)

        full_train = fetch(0, lib.qm_num_train(h))
        test = fetch(1, lib.qm_num_test(h))
    finally:
        lib.qm_free(h)

    n_all = len(full_train)
    if shuffle_split:
        # EN_SAMPLE_SHUFFLED split semantics (MemN2N.c:1046-1052, :1868):
        # one global permutation up front, valid = its tail.  Permuting
        # the vectorized rows here is equivalent to the Python loader's
        # permutation of raw samples (vectorization is per-sample).
        perm = np.random.default_rng(split_seed).permutation(n_all)
        full_train = VectorizedSplit(
            full_train.memory[perm], full_train.question[perm],
            full_train.answer[perm], full_train.n_sen[perm],
            full_train.answer_index[perm])
    n_valid = int(n_all * rate_valid)
    n_train = n_all - n_valid

    def slc(v: VectorizedSplit, s, e):
        return VectorizedSplit(v.memory[s:e], v.question[s:e],
                               v.answer[s:e], v.n_sen[s:e],
                               v.answer_index[s:e])

    return TaskData(slc(full_train, 0, n_train),
                    slc(full_train, n_train, n_all), test, dims, dictionary)
