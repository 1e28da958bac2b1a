"""The chunked step dispatch of splice_tpu_torch: the step's draws and
lambdas as data, the chunk boundaries, and the chunk loop against eager
steps.

  * the data-driven structure_augment / texture_augment against the
    reference's key-based ones (static_ctrl=False), with the draws taken
    from the same key as the reference splits it: fp32, atol 2e-6 (the
    hue round trip and the blur's exp in two libraries);
  * the data-driven form against the branching one (each op applied in
    Python order, each coin a Python if), every coin combination and every
    jitter order: bitwise;
  * lambdas_vec and the vector-weighted total against the dict form;
  * the chunk plan against the reference's boundaries_after walk (with
    the checkpoint and plateau candidates, and from a resumed run's first
    step);
  * train_pair's chunk loop on the CPU against eager SpliceTrainer.step
    calls: in tests/test_torch_chunk_loop.py.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splice_tpu import trainer as jtrainer
from splice_tpu.config import Config as JConfig
from splice_tpu.ops import image as jimg
from splice_tpu_torch import losses as tlosses
from splice_tpu_torch import trainer as ttrainer
from splice_tpu_torch.config import Config as TConfig
from splice_tpu_torch.ops import image as timg

AUG_ATOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def _draws_from_key(key):
    """structure_augment's draws as splice_tpu/ops/image.py:112-305 takes
    them from `key` (static_ctrl=False), as float32 tensors."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kb, kc, ks, kh, kperm = jax.random.split(k2, 5)
    k_apply, k_sigma = jax.random.split(k4)
    factors = [jax.random.uniform(kb, (), minval=0.6, maxval=1.4),
               jax.random.uniform(kc, (), minval=0.6, maxval=1.4),
               jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
               jax.random.uniform(kh, (), minval=-0.1, maxval=0.1)]
    order = jnp.argsort(jax.random.uniform(kperm, (4,)))
    sigma = jax.random.uniform(k_sigma, (), minval=0.1, maxval=2.0)
    t = lambda v: torch.tensor(np.asarray(v, np.float32))
    return dict(flip=t(jax.random.bernoulli(k1, 0.5)),
                jitter_on=t(jax.random.bernoulli(k3, 0.5)),
                jitter_factors=t(factors), jitter_order=t(order),
                blur_on=t(jax.random.bernoulli(k_apply, 0.2)), sigma=t(sigma))


# PRNGKey seeds: nothing on (0), flip and jitter (3), jitter and blur (6),
# flip and blur (11)
@pytest.mark.parametrize("seed", [0, 3, 6, 11])
def test_augment_matches_reference_key_form(seed):
    x = _img(18, 22, seed=seed)
    key = jax.random.PRNGKey(seed)
    draws = _draws_from_key(key)
    want = jax.jit(lambda im, k: jimg.structure_augment(
        im, k, static_ctrl=False))(jnp.asarray(x), key)
    got = timg.structure_augment(torch.from_numpy(x), **draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=AUG_ATOL)
    flip = torch.tensor(np.float32(jax.random.bernoulli(key, 0.5)))
    np.testing.assert_array_equal(
        timg.texture_augment(torch.from_numpy(x), flip).numpy(),
        np.asarray(jimg.texture_augment(jnp.asarray(x), key)))


def test_reference_keys_cover_every_coin():
    """The seeds above turn each coin on at least once and off once."""
    seen = {k: set() for k in ("flip", "jitter_on", "blur_on")}
    for seed in (0, 3, 6, 11):
        d = _draws_from_key(jax.random.PRNGKey(seed))
        for k in seen:
            seen[k].add(bool(d[k]))
    assert all(v == {False, True} for v in seen.values())


def _branching(img, flip, jitter_on, factors, order, blur_on, sigma):
    """The structure augmentation as Python branches over Python draws."""
    if flip:
        img = torch.flip(img, dims=(1,))
    if jitter_on:
        ops = (timg.adjust_brightness, timg.adjust_contrast,
               timg.adjust_saturation, timg.adjust_hue)
        for op in order:
            img = ops[op](img, factors[op])
    if blur_on:
        img = timg.gaussian_blur3(img, sigma)
    return img


def test_data_form_matches_branching_form_bitwise():
    x = torch.from_numpy(_img(9, 11, seed=1))
    factors = (1.27, 0.71, 1.13, -0.06)
    fac_t = torch.tensor(factors, dtype=torch.float32)
    n = 0
    for flip, jit_on, blur in itertools.product((False, True), repeat=3):
        for order in itertools.permutations(range(4)):
            got = timg.structure_augment(
                x, torch.tensor(float(flip)), torch.tensor(float(jit_on)),
                fac_t, torch.tensor(order, dtype=torch.float32),
                torch.tensor(float(blur)), torch.tensor(0.83))
            want = _branching(x, flip, jit_on, factors, order, blur, 0.83)
            assert torch.equal(got, want), (flip, jit_on, blur, order)
            n += 1
    assert n == 8 * 24
    for flip in (False, True):
        assert torch.equal(timg.texture_augment(x, torch.tensor(float(flip))),
                           torch.flip(x, dims=(1,)) if flip else x)


@pytest.mark.parametrize("step", [0, 1, 2, 75, 150])
def test_lambdas_vec_and_vector_total_match_dict_form(step):
    jc, tc = JConfig(cls_warmup=2), TConfig(cls_warmup=2)
    lam = tlosses.lambdas_for_step(tc, step)
    vec = ttrainer.lambdas_vec(tc, step)
    np.testing.assert_array_equal(vec, jtrainer.lambdas_vec(jc, step))
    assert vec.dtype == np.float32
    assert ttrainer.LOSS_KEYS[:5] == jtrainer.LOSS_NAMES
    assert tlosses.LAMBDA_ORDER == jtrainer.LAMBDA_ORDER
    parts = {"loss_global_ssim": torch.tensor(2.0),
             "loss_global_cls": torch.tensor(0.5),
             "loss_global_id_B": torch.tensor(3.0)}
    if tlosses.is_entire_step(tc, step):
        parts.update(loss_entire_ssim=torch.tensor(0.75),
                     loss_entire_cls=torch.tensor(0.25))
    assert torch.equal(tlosses.weighted_total(parts, torch.from_numpy(vec)),
                       tlosses.weighted_total(parts, lam))


# (config, steps, the plan): the walk of the reference's boundaries_after
# (splice_tpu/trainer.py:644-676) and its loop (:707-731), which runs an
# entire-A step alone and the regular steps up to the next boundary, for
# configs without profile keys, written out by hand.
PLANS = [
    (dict(entire_A_every=10, log_images_freq=1000, cls_warmup=1), 12,
     [(0, 1, True), (1, 9, False), (10, 1, True), (11, 1, False)]),
    (dict(entire_A_every=10, log_images_freq=1000, cls_warmup=1), 4,
     [(0, 1, True), (1, 3, False)]),
    (dict(entire_A_every=75, log_images_freq=10, cls_warmup=3), 26,
     [(0, 1, True), (1, 2, False), (3, 7, False), (10, 10, False),
      (20, 6, False)]),
    (dict(entire_A_every=4, log_images_freq=6, cls_warmup=0), 13,
     [(0, 1, True), (1, 3, False), (4, 1, True), (5, 1, False),
      (6, 2, False), (8, 1, True), (9, 3, False), (12, 1, True)]),
    (dict(entire_A_every=5, log_images_freq=3, cls_warmup=1,
          lambda_entire_ssim=0.0, lambda_entire_cls=0.0), 8,
     [(0, 1, False), (1, 2, False), (3, 3, False), (6, 2, False)]),
    # the checkpoint boundary, a multiple of checkpoint_every
    (dict(log_images_freq=10, checkpoint_every=4, checkpoint_dir="ck"), 13,
     [(0, 1, True), (1, 3, False), (4, 4, False), (8, 2, False),
      (10, 2, False), (12, 1, False)]),
    # checkpoint_every without a directory: no checkpoint, no boundary
    (dict(log_images_freq=10, checkpoint_every=4), 12,
     [(0, 1, True), (1, 9, False), (10, 2, False)]),
    # plateau caps a chunk at PLATEAU_PATIENCE + 1 steps
    (dict(log_images_freq=10, scheduler_policy="plateau"), 16,
     [(0, 1, True), (1, 6, False), (7, 3, False), (10, 6, False)]),
]


@pytest.mark.parametrize("kw,steps,plan", PLANS)
def test_chunk_plan_matches_reference_walk(kw, steps, plan):
    assert ttrainer.chunk_plan(TConfig(**kw), steps) == plan


# (config, first step, steps, the plan) of a resumed run: the reference's
# loop from step_idx = start_epoch - 1, written out by hand.
RESUMED_PLANS = [
    (dict(log_images_freq=10, checkpoint_every=4, checkpoint_dir="ck"), 6,
     13, [(6, 2, False), (8, 2, False), (10, 2, False), (12, 1, False)]),
    (dict(entire_A_every=10, log_images_freq=1000), 10, 12,
     [(10, 1, True), (11, 1, False)]),
    (dict(checkpoint_every=100, checkpoint_dir="ck"), 200, 300,
     [(200, 10, False), (210, 10, False), (220, 5, False), (225, 1, True),
      (226, 4, False)] + [(i, 10, False) for i in range(230, 300, 10)]),
    (dict(), 12, 12, []),
]


@pytest.mark.parametrize("kw,start,steps,plan", RESUMED_PLANS)
def test_chunk_plan_from_a_first_step(kw, start, steps, plan):
    assert ttrainer.chunk_plan(TConfig(**kw), steps, start) == plan
