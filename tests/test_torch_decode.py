"""The port's ``decode_step`` against the JAX reference on reduced
deepseek-7b and glm4-9b, on the CPU: 4 teacher-forced steps (logits each
step, then the ring cache's k/v and slot positions), in both facility
modes, and once with a 3-slot ring that wraps.  Fixture, modes and
tolerances are tests/test_torch_model.py's (see its docstring)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.core import facility as tfac
from repro_torch.models import model as TM
from test_torch_model import (B, CONFIGS, DECODE, S, _close,  # noqa: F401
                              _reference_mode, models)


@pytest.mark.parametrize("mode,clen", [("f32", S), ("bf16", S), ("bf16", 3)])
def test_decode_steps_match_reference(models, mode, clen):
    """4 teacher-forced steps; with clen=3 the ring wraps and overwrites
    its oldest slot."""
    jcfg, tcfg, params, model, tokens = models
    _, tkw, jdt, tdt, tol = CONFIGS[mode]
    with _reference_mode(mode):
        jcache = JM.init_cache(jcfg, B, clen, dtype=jdt)
        jsteps = []
        for t in range(DECODE):
            lg, jcache = JM.decode_step(params, jcache,
                                        jnp.asarray(tokens[:, t:t + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with tfac.configure(tfac.FacilityConfig(device="cpu", **tkw)):
        tcache = TM.init_cache(tcfg, B, clen, device="cpu", dtype=tdt)
        for t in range(DECODE):
            lg, tcache = TM.decode_step(
                model, tcache, torch.from_numpy(tokens[:, t:t + 1]), tcfg)
            _close(lg.numpy(), jsteps[t], tol, f"decode step {t} logits")
    assert tcache["cur"] == int(jcache["cur"]) == DECODE
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for what in ("k", "v"):
        _close(tcache[what].float().numpy(),
               np.asarray(jcache[what], np.float32), tol,
               f"decode {what} cache")

