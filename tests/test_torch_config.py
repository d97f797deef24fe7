"""The port's knobs (`config.py`) and logger (`utils/log.py`): the knobs
that apply on the card and nothing else, `describe`, the readers that
take their value through a knob, and the logger's process prefix."""

import pytest

from cuda_flashattention_torch import config
from cuda_flashattention_torch.utils import log


def test_all_knobs_are_the_ones_that_apply_on_the_card():
    names = {k.name for k in config.all_knobs().values()}
    assert names == {"CFA_LOG_LEVEL", "CFA_LOG_ALL_PROCS",
                     "CFA_AUTOTUNE_CACHE", "CFA_NATIVE_CACHE",
                     "CFA_LADDER_SEQ", "CFA_COORD", "CFA_NPROC", "CFA_PID",
                     "CFA_LOCAL_RANKS", "CFA_CPU"}
    assert config.AUTOTUNE_CACHE.default.endswith(
        "/.cache/cfa_torch/autotune.json")


def test_describe_marks_set_knobs(monkeypatch):
    monkeypatch.delenv("CFA_LOG_LEVEL", raising=False)
    text = config.describe()
    for knob in config.all_knobs().values():
        assert knob.name in text
    assert "(set:" not in text.split("CFA_LOG_LEVEL")[1].split("\n")[0]
    monkeypatch.setenv("CFA_LOG_LEVEL", "DEBUG")
    assert "(set: 'DEBUG')" in config.describe()


def test_knob_values(monkeypatch):
    monkeypatch.setenv("CFA_LADDER_SEQ", "2544")
    assert config.LADDER_SEQ.as_int == 2544
    monkeypatch.setenv("CFA_LOG_ALL_PROCS", "1")
    assert config.LOG_ALL_PROCS.as_bool
    monkeypatch.delenv("CFA_LOG_ALL_PROCS")
    assert not config.LOG_ALL_PROCS.as_bool


def test_native_cache_reads_the_knob(monkeypatch, tmp_path):
    from cuda_flashattention_torch.runtime import native
    monkeypatch.setenv("CFA_NATIVE_CACHE", str(tmp_path))
    assert native.cache_dir() == tmp_path
    monkeypatch.delenv("CFA_NATIVE_CACHE")
    assert native.cache_dir() == native.DEFAULT_CACHE


def test_logger_prefix_and_name(capsys):
    logger = log.get_logger("tests.here")
    assert logger.name == "cuda_flashattention_torch.tests.here"
    assert log.get_logger("cuda_flashattention_torch.x").name == (
        "cuda_flashattention_torch.x")
    logger.warning("hello %d", 7)
    err = capsys.readouterr().err
    assert err.startswith("[p0] ") and "WARNING" in err
    assert "cuda_flashattention_torch.tests.here: hello 7" in err


def test_logger_prints_on_process_zero_only(monkeypatch, capsys):
    logger = log.get_logger("tests.rank")
    monkeypatch.setattr(log, "process_index", lambda: 1)
    logger.warning("from rank one")
    assert "from rank one" not in capsys.readouterr().err
    monkeypatch.setenv("CFA_LOG_ALL_PROCS", "1")
    logger.warning("from rank one")
    assert capsys.readouterr().err.startswith("[p1] ")


def test_process_index_without_a_group():
    assert log.process_index() == 0


def test_time_fn_needs_a_card(monkeypatch):
    import torch
    from cuda_flashattention_torch.utils.timing import time_fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        time_fn(lambda x: x, 1)
