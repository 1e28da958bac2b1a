"""The port's API wrappers and tools against the reference's.

models.model (define_G, Model), losses.LossG, tools.evaluate and
tools.inversion at fp32 on the CPU, the same inputs (numpy, seeded) and
weights in both packages. A tiny ViT (depth 1, width 64, 2 heads) and
2-scale generators keep each JAX program to about a second of compile (the
end-to-end inversion: a 1-scale net). Tolerances: values at rtol 1e-5 with
atol 1e-6 (the resize of preprocess 1e-5 x the largest value; PSNR and
SSIM, float64 on both sides, at 1e-12); gradients at rtol 1e-4 with atol
1e-3 x the largest entry (the keys' Gram MSE sums many cancelling
products). The inversion step's
reference is composed from the reference's public functions; the CHW
step is held against the reference's NHWC composition, the same function
(single-pass BatchNorm statistics against the deviation form: 1e-6 apart at
these sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from splice_tpu.config import Config as JConfig
from splice_tpu.models import extractor as jext
from splice_tpu.models import model as jmodel
from splice_tpu.models import unet as junet
from splice_tpu.models import vit as jvit
from splice_tpu.ops import image as jimg
from splice_tpu.tools import evaluate as jeval
from splice_tpu_torch import losses as tlosses
from splice_tpu_torch.config import load_config
from splice_tpu_torch.models import extractor as text
from splice_tpu_torch.models import model as tmodel
from splice_tpu_torch.models import unet as tunet
from splice_tpu_torch.models import vit as tvit
from splice_tpu_torch.models.weights import vit_params_from_numpy
from splice_tpu_torch.tools import evaluate as teval
from splice_tpu_torch.tools import inversion as tinv
from splice_tpu_torch.utils.tree import tree_map

TINY = dict(patch_size=8, embed_dim=64, depth=1, num_heads=2, img_size=32)
SMALL = dict(channels_down=(8, 8), channels_up=(8, 8), channels_skip=(2, 2))
ONE_SCALE = dict(channels_down=(4,), channels_up=(4,), channels_skip=(2,),
                 pad="reflection")
LIMES = "datasets/feature_visualization/limes.jpeg"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: pytest-xdist runs
    six workers, and a torch thread pool in each oversubscribes the host
    (tests/test_torch_pairs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def extractors():
    jp = jax.tree.map(np.asarray, jvit.init_vit_params(
        jax.random.PRNGKey(2), jvit.VitConfig(**TINY)))
    return (jext.VitExtractor(params=jp, cfg=jvit.VitConfig(**TINY)),
            text.VitExtractor(params=vit_params_from_numpy(jp, "cpu"),
                              cfg=tvit.VitConfig(**TINY)))


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def test_define_g_matches_the_reference_tree():
    """define_G's tree (paths and shapes) is the reference's under every
    init (the default net's flat order: test_torch_unet)."""
    assert tmodel.define_G(device="cpu")[1] == tunet.SkipConfig()

    def layout(tree):
        return [(p, a.shape) for p, a in
                jax.tree_util.tree_leaves_with_path(tree)]

    small = layout(jmodel.define_G("normal", 0.02, jax.random.PRNGKey(1),
                                   junet.SkipConfig(**SMALL))[0])
    for init in ("normal", "xavier", "kaiming", "orthogonal"):
        tp, _ = tmodel.define_G(init, 0.02, 1, tunet.SkipConfig(**SMALL),
                                "cpu")
        assert layout(tree_map(np.asarray, tp)) == small


@pytest.mark.parametrize("entire_ssim,entire_cls", [(1.0, 10.0), (0.0, 10.0)])
def test_model_dict_surface(entire_ssim, entire_cls):
    """Model(cfg)(inputs) on the reference's dicts, the entire-A gate on
    either entire lambda (with entire ssim 0 and cls 10 the reference
    gates x_entire on too; PARITY.md deviation 5)."""
    kw = dict(lambda_entire_ssim=entire_ssim, lambda_entire_cls=entire_cls,
              entire_A_every=5)
    gcfg = dict(SMALL, pad="reflection")
    jm = jmodel.Model(JConfig(**kw), jax.random.PRNGKey(3),
                      junet.SkipConfig(**gcfg))
    jm.netG = jax.jit(jm.netG)          # one compile per input shape
    tm = tmodel.Model(load_config(None, kw), gcfg=tunet.SkipConfig(**gcfg),
                      device="cpu")
    tm.params = tree_map(torch.from_numpy, jax.tree.map(np.asarray,
                                                        jm.params))
    arrays = dict(A=_rand(4, 1, 24, 28, 3), A_global=_rand(5, 2, 16, 16, 3),
                  B_global=_rand(6, 1, 16, 16, 3))
    for step, keys in ((10, {"x_global", "x_entire", "y_global"}),
                       (11, {"x_global", "y_global"})):
        jo = jm({"step": step, **{k: jnp.asarray(v)
                                   for k, v in arrays.items()}})
        to = tm({"step": step, **{k: torch.from_numpy(v)
                                   for k, v in arrays.items()}})
        assert set(jo) == set(to) == keys
        for k in keys:
            _close(to[k].numpy(), jo[k])


def test_lossg_dict_surface(extractors):
    """Every term of LossG on an entire-A step (two A crops against one B
    crop: the cls pairs truncate to one; x_entire against the first B crop
    only) and the total's gradient with respect to x_global; then a
    regular step drops the entire terms and keeps the others' values."""
    from splice_tpu import losses as jlosses
    je, te = extractors
    kw = dict(dino_global_patch_size=32, dino_global_max_size=64,
              entire_A_every=5)
    jl = jlosses.LossG(JConfig(**kw), je)
    tl = tlosses.LossG(load_config(None, dict(kw, device="cpu")), te)
    out = dict(x_global=_rand(7, 2, 24, 24, 3),
               x_entire=_rand(8, 1, 28, 36, 3),
               y_global=_rand(9, 1, 24, 24, 3))
    inp = dict(A=_rand(10, 1, 28, 36, 3), A_global=_rand(11, 2, 24, 24, 3),
               B_global=_rand(12, 1, 24, 24, 3))

    def jf(xg):
        o = {k: (xg if k == "x_global" else jnp.asarray(v))
             for k, v in out.items()}
        terms = jl(o, {"step": 5, **{k: jnp.asarray(v)
                                     for k, v in inp.items()}})
        return terms["loss"], terms

    (_, jo), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(out["x_global"]))
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    xg = torch.from_numpy(out["x_global"]).requires_grad_(True)
    tout = {**{k: torch.from_numpy(v) for k, v in out.items()},
            "x_global": xg}
    to = tl(tout, {"step": 5, **tin})
    assert set(jo) == set(to) and len(to) == 6
    for k in jo:
        _close(to[k].detach().numpy(), jo[k])
    to["loss"].backward()
    jg = np.asarray(jg)
    np.testing.assert_allclose(xg.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-3 * np.abs(jg).max())
    regular = tl(tout, {"step": 6, **tin})
    assert set(regular) == set(to) - {"loss_entire_ssim", "loss_entire_cls"}
    for k in ("loss_global_ssim", "loss_global_cls", "loss_global_id_B"):
        assert torch.equal(regular[k], to[k])


def test_psnr_ssim():
    a, b = _rand(13, 20, 24, 3), _rand(14, 20, 24, 3)
    b = 0.7 * a + 0.3 * b
    for fn in ("psnr", "ssim"):
        want = getattr(jeval, fn)(a, b)
        np.testing.assert_allclose(getattr(teval, fn)(a, b), want,
                                   rtol=1e-12)
    assert teval.psnr(a, a) == float("inf")
    np.testing.assert_allclose(teval.ssim(a[..., 0], b[..., 0]),
                               jeval.ssim(a[..., 0], b[..., 0]), rtol=1e-12)


def _lpips_weights(seed):
    rng = np.random.default_rng(seed)
    shapes = {"conv1": (64, 3, 11, 11), "conv2": (192, 64, 5, 5),
              "conv3": (384, 192, 3, 3), "conv4": (256, 384, 3, 3),
              "conv5": (256, 256, 3, 3)}
    w = {}
    for i, (name, s) in enumerate(shapes.items()):
        fan_in = s[1] * s[2] * s[3]
        w[f"{name}_w"] = (rng.standard_normal(s) / np.sqrt(fan_in)).astype(
            np.float32)
        w[f"{name}_b"] = (0.1 * rng.standard_normal(s[0])).astype(np.float32)
        w[f"lin{i + 1}_w"] = rng.random((1, s[0])).astype(np.float32)
    return w


def test_lpips_seeded_weights(tmp_path):
    w = _lpips_weights(15)
    a, b = _rand(16, 64, 72, 3), _rand(17, 64, 72, 3)
    want = jeval.lpips(a, b, w)
    _close(teval.lpips(a, b, w, device="cpu"), want)
    np.savez(tmp_path / "w.npz", **w)
    _close(teval.lpips(a, b, str(tmp_path / "w.npz"), device="cpu"), want)


def test_port_lpips_weights_bitwise(tmp_path):
    rng = np.random.default_rng(18)
    alex, lin = {}, {}
    for idx, c in zip((0, 3, 6, 8, 10), (4, 6, 8, 8, 6)):
        alex[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((c, 3, 2, 2)).astype(np.float32))
        alex[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(c).astype(np.float32))
    for i, c in enumerate((4, 6, 8, 8, 6)):
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(
            rng.random((1, c, 1, 1)).astype(np.float32))
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(lin, tmp_path / "lin.pth")
    outs = [mod.port_lpips_weights(str(tmp_path / "alex.pth"),
                                   str(tmp_path / "lin.pth"),
                                   str(tmp_path / f"{name}.npz"))
            for name, mod in (("j", jeval), ("t", teval))]
    j, t = np.load(outs[0]), np.load(outs[1])
    assert sorted(j.files) == sorted(t.files) and len(t.files) == 15
    for k in j.files:
        assert j[k].dtype == t[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_noise_mag_schedule():
    got = [tinv.noise_mag_at(i, "cls", 3, 6) for i in range(8)]
    assert got == [10.0] * 3 + [2.0] * 3 + [0.5] * 2
    assert all(tinv.noise_mag_at(i, "keys", 3, 6) == 0.0 for i in range(8))


def test_preprocess_keeps_the_aspect():
    """tests/test_tools.py:68-84's case: a 64 x 88 image reaches the ViT at
    224 x 308; a 224-short image passes unresized."""
    x = _rand(19, 1, 64, 88, 3)
    shape = jimg.dino_resize_shape(64, 88, 224, None)
    want = jimg.imagenet_normalize(jimg.resize(jnp.asarray(x), shape))
    got = tinv.preprocess(torch.from_numpy(x))
    assert tuple(got.shape[1:3]) == shape == (224, 308)
    # the resize's fp32 sums in another order: 1e-5 x the largest value
    _close(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    y = _rand(20, 1, 224, 230, 3)
    _close(tinv.preprocess(torch.from_numpy(y)).numpy(),
           jimg.imagenet_normalize(jnp.asarray(y)))


@pytest.mark.parametrize("layout,feature", [("nhwc", "cls"),
                                            ("chw", "keys")])
def test_inversion_step_loss_and_grad(extractors, layout, feature):
    """One iteration's loss and parameter gradient (inversion.step_loss,
    the noise passed in) against the same step composed from the
    reference: skip_apply, dino_resize_shape, resize, imagenet_normalize,
    the extractor's block tap or keys, the fp32 MSE."""
    je, te = extractors
    kw = dict(SMALL, pad="reflection", num_input_channels=4)
    jcfg, tcfg = junet.SkipConfig(**kw), tunet.SkipConfig(**kw)
    jp = junet.init_skip_params(jax.random.PRNGKey(21), jcfg)
    base, noise = _rand(22, 1, 20, 28, 4), _rand(23, 1, 20, 28, 4) - 0.5
    mag, layer = 2.0, 0
    target = _rand(24, 1, 20, 28, 3)

    def jfeat(img):
        shape = jimg.dino_resize_shape(img.shape[1], img.shape[2], 224, None)
        y = jimg.imagenet_normalize(jimg.resize(img, shape))
        if feature == "cls":
            return je._run(y, {"block": (layer,)})["block"][layer][:, 0, :]
        return je.get_keys_from_input(y, layer)

    ref = jfeat(jnp.asarray(target))

    def jloss(p):
        f = jfeat(junet.skip_apply(p, jcfg, jnp.asarray(base + mag * noise)))
        return jnp.mean(jnp.square(f - ref))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    jg = np.asarray(ravel_pytree(jg)[0])

    def g_apply(p, x):
        if layout == "chw":
            return tunet.skip_apply_chw(p, tcfg, x, conv_impl="pallas")
        return tunet.skip_apply(p, tcfg, x)

    flat, spec = tunet.flatten_params(tree_map(torch.from_numpy,
                                               jax.tree.map(np.asarray, jp)))
    flat.requires_grad_(True)
    tref = tinv.extract(te, torch.from_numpy(target), feature, layer)
    tl = tinv.step_loss(g_apply, tunet.unflatten_params(flat, spec), te,
                        tref, torch.from_numpy(base), torch.from_numpy(noise),
                        mag, feature, layer)
    tl.backward()
    _close(tl.item(), jl)
    np.testing.assert_allclose(flat.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-3 * np.abs(jg).max())


def test_invert_end_to_end_log_indices(tmp_path, monkeypatch):
    """Both packages' invert on limes (tiny ViT, a 1-scale net in place of
    inversion_skip_config; three steps at log_freq 2, chunks of 1 and 2):
    the callback sees the same steps, each loss finite, the PNG and the
    ViT's input size as the reference's. Then the port alone at the
    reference test's schedule (10 steps, log_freq 4)."""
    from splice_tpu.tools import inversion as jinv
    jvit.VIT_CONFIGS["_inv_tiny"] = jvit.VitConfig(**TINY)
    tvit.VIT_CONFIGS["_inv_tiny"] = tvit.VitConfig(**TINY)
    monkeypatch.setattr(junet, "inversion_skip_config", lambda d: (
        junet.SkipConfig(num_input_channels=d, **ONE_SCALE)))
    monkeypatch.setattr(tunet, "inversion_skip_config", lambda d: (
        tunet.SkipConfig(num_input_channels=d, **ONE_SCALE)))
    args = dict(feature="cls", layer=0, dino_model_name="_inv_tiny",
                n_iter=3, noise_stage_1=1, noise_stage_2=2, log_freq=2,
                resize=48, input_depth=4, compute_dtype="float32")
    try:
        logs = {"j": [], "t": []}
        jres = jinv.invert(LIMES, str(tmp_path / "j.png"), **args,
                           callback=lambda i, l, o: logs["j"].append(i))
        tres = tinv.invert(LIMES, str(tmp_path / "t.png"), **args,
                           device="cpu",
                           callback=lambda i, l, o: logs["t"].append(
                               (i, l, (o.device.type, *o.shape))))
        steps = []
        long = tinv.invert(LIMES, str(tmp_path / "t10.png"),
                           **dict(args, n_iter=10, log_freq=4,
                                  noise_stage_1=3, noise_stage_2=6),
                           device="cpu",
                           callback=lambda i, l, o: steps.append(i))
    finally:
        del jvit.VIT_CONFIGS["_inv_tiny"], tvit.VIT_CONFIGS["_inv_tiny"]
    assert [i for i, _, _ in logs["t"]] == logs["j"] == [0, 2]
    # the image reaches the callback on the host (the reference hands it a
    # host array)
    assert all(np.isfinite(l) and s == ("cpu", 48, 60, 3)
               for _, l, s in logs["t"])
    assert tres["chunks"] == [1, 2] and np.isfinite(tres["loss"])
    assert tres["dino_input_hw"] == jres["dino_input_hw"] == (224, 280)
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "t.png")).shape == (48, 60, 3)
    assert steps == [0, 4, 8] and long["chunks"] == [1, 4, 4, 1]


def test_tools_default_to_cuda(tmp_path):
    """invert, lpips, define_G and Model run on CUDA unless told the CPU:
    without a card they raise."""
    if torch.cuda.is_available():
        return
    a = _rand(25, 64, 64, 3)
    for call in (lambda: tinv.invert(LIMES, str(tmp_path / "x.png")),
                 lambda: teval.lpips(a, a, _lpips_weights(26)),
                 lambda: tmodel.define_G(),
                 lambda: tmodel.Model(load_config(None, {}))):
        with pytest.raises(RuntimeError):
            call()
