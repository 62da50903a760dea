"""The port's serving loop and page pool against the JAX reference, on the
CPU, and the rule that entry points run on the card unless asked for the
CPU (here, with no card, their defaults raise)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.runtime.kv_pages import (PageAccountingError, PagePool,
                                          PagesExhausted)

COMPARED = ("completed", "rejected", "steps", "decode_tokens",
            "prefill_tokens", "latency_p50_steps", "latency_p99_steps",
            "pages")


@pytest.fixture(scope="module")
def served():
    jcfg = jreduced(jget("deepseek-7b"))
    tcfg = treduced(tget("deepseek-7b"))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu", dtype=torch.bfloat16)
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("kw", [
    dict(batch=2, prompt_len=8, gen_len=6, n_requests=3),
    # page pressure: the pool covers one request at a time, so admission
    # queues and drains as pages are reclaimed
    dict(batch=2, prompt_len=8, gen_len=6, n_requests=3, page_size=4,
         total_pages=4),
    # a footprint larger than the whole pool is rejected up front
    dict(batch=2, prompt_len=8, gen_len=6, n_requests=2, page_size=4,
         total_pages=3),
])
def test_serve_loop_matches_reference(served, kw):
    jcfg, tcfg, params, model = served
    want = jserve.serve_loop(jcfg, params, seed=0, **kw)
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tserve.serve_loop(tcfg, model, seed=0, **kw)
    for key in COMPARED:
        assert got[key] == want[key], key
    assert got["completed"] + got["rejected"] == kw["n_requests"]


@pytest.mark.parametrize("name", ["whisper-small", "qwen2-vl-7b"])
def test_serve_loop_refuses_multimodal_configs(name):
    """The loop admits token-only prompts, as the reference's does (where
    these configs fail on the missing frames or positions): an
    encoder-decoder or vision-prefix config is refused up front, before
    any model call."""
    cfg = treduced(tget(name))
    model = TM.init_params(cfg, device="cpu", dtype=torch.bfloat16)
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        with pytest.raises(ValueError, match="token-only prompts"):
            tserve.serve_loop(cfg, model, batch=2, prompt_len=8, gen_len=2,
                              n_requests=1)


def test_requests_match_reference():
    cfg = treduced(tget("deepseek-7b"))
    mine = tserve._make_requests(cfg, 5, 7, 9, seed=3)
    ref = jserve._make_requests(cfg, 5, 7, 9, seed=3, max_retries=2)
    for a, b in zip(mine, ref):
        assert a.gen_len == b.gen_len
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_pool_alloc_free_exactly_once():
    pool = PagePool(total_pages=6, page_size=4)
    assert pool.pages_for(9) == 3 and pool.pages_for(0) == 1
    a = pool.alloc(1, 9)
    assert len(a.pages) == 3 and pool.free_pages == 3
    with pytest.raises(PageAccountingError, match="double admission"):
        pool.alloc(1, 4)
    assert pool.free(1) == 3
    with pytest.raises(PageAccountingError, match="double free"):
        pool.free(1)
    with pytest.raises(PageAccountingError):
        pool.free(99)                      # never admitted
    pool.assert_quiescent()
    assert pool.stats()["high_water_pages"] == 3


def test_pool_exhaustion_allocates_nothing_partially():
    pool = PagePool(total_pages=4, page_size=4)
    pool.alloc(1, 12)
    with pytest.raises(PagesExhausted):
        pool.alloc(2, 8)
    assert pool.free_pages == 1 and not pool.holds(2)
    assert not pool.fits(17) and pool.fits(16)


def test_pool_quiescence_detects_leak():
    pool = PagePool(total_pages=2, page_size=4)
    pool.alloc(7, 4)
    with pytest.raises(PageAccountingError, match="leaked"):
        pool.assert_quiescent()
    with pytest.raises(ValueError):
        PagePool(total_pages=0, page_size=4)


def test_defaults_run_on_the_card_or_raise():
    """With no CUDA, the defaults raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg = treduced(tget("deepseek-7b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfac.FacilityConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfac.current()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfac.contract(tfac.DOT, torch.zeros((2, 4)), torch.zeros((4, 2)))


def test_main_on_the_cpu_when_asked(capsys):
    out = tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3", "--requests", "2"])
    assert out["completed"] == 2
    assert "served 2 requests" in capsys.readouterr().out
