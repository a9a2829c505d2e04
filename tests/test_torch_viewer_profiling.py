"""Port parity for the small modules: ``utils/viewer_html.py`` and the
tools ``view_scene`` and ``compute_metrics`` against the JAX package's
module and the repo's ``tools/`` scripts (run in this process with their
own ``sys.argv``), and ``profiling.py`` on the CPU.

The viewer's HTML and ``.splat`` bytes must be equal byte for byte; the
tools' outputs too (``all_metric.json``: the proxies are the same numpy
code in both packages, so the numbers are equal, not close). The CLIP
score, on towers at reduced widths loaded from JAX's random variables,
is held against the JAX tool's ``clip_encode`` arithmetic to 1e-5 (fp32
cosines).
"""
import importlib.util
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from prometheus_tpu.utils import gs_io as jgs_io
from prometheus_tpu.utils import viewer_html as jviewer
from prometheus_torch import profiling
from prometheus_torch.tools import compute_metrics, view_scene
from prometheus_torch.utils import viewer_html
from prometheus_torch.weights import load_jax_params

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def random_gaussians(n=300, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, n, 4))
    return (rng.normal(size=(1, n, 3)).astype(np.float32),
            rng.uniform(0, 1, (1, n, 1, 3)).astype(np.float32),
            rng.uniform(0, 1, (1, n, 1)).astype(np.float32),
            rng.uniform(0.01, 0.2, (1, n, 3)).astype(np.float32),
            (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(
                np.float32))


def run_jax_tool(name: str, argv: list, monkeypatch):
    """The repo's ``tools/<name>.py`` ``main()`` with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


@pytest.mark.parametrize("as_tensors", [False, True])
def test_viewer_html_and_splat_bytes(tmp_path, as_tensors):
    g = random_gaussians()
    port_in = tuple(torch.from_numpy(a) for a in g) if as_tensors else g
    data = viewer_html.gaussians_to_splat_bytes(port_in, 0.2)
    assert data == jviewer.gaussians_to_splat_bytes(g, 0.2)
    assert len(data) % 32 == 0 and 0 < len(data) < 300 * 32
    a = viewer_html.export_viewer_html(str(tmp_path / "port"), data,
                                       title="t", max_splats=100)
    b = jviewer.export_viewer_html(str(tmp_path / "jax"), data, title="t",
                                   max_splats=100)
    assert a.endswith(".html")
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("kind", ["ply", "splat", "fetch"])
def test_view_scene_matches_the_repo_tool(tmp_path, monkeypatch, kind):
    g = random_gaussians(seed=1)
    scene = str(tmp_path / f"scene.{'ply' if kind == 'ply' else 'splat'}")
    (jgs_io.export_ply if kind == "ply" else jgs_io.export_splat)(scene, g)
    extra = ["--fetch"] if kind == "fetch" else ["--max_splats", "200"]
    port_out = str(tmp_path / "port.html")
    path = view_scene.main([scene, "--out", port_out] + extra)
    assert path == port_out
    run_jax_tool("view_scene", [scene, "--out", str(tmp_path / "jax.html")]
                 + extra, monkeypatch)
    with open(port_out) as fa, open(tmp_path / "jax.html") as fb:
        assert fa.read() == fb.read()


def write_gallery(root, seed=0):
    """Two prompts in the eval CLI's layout (``view_NN.png`` and a grid
    that is not scored) and one in director3d's nested layout."""
    rng = np.random.default_rng(seed)
    img = lambda: Image.fromarray(                   # noqa: E731
        (rng.random((64, 64, 3)) * 255).astype(np.uint8))
    for p in ("a_red_car", "a_wooden_cabin"):
        os.makedirs(root / p)
        for i in range(2):
            img().save(root / p / f"view_{i:02d}.png")
        img().save(root / p / "grid.png")
    nested = root / "a_toy" / "0" / "a_toy"
    os.makedirs(nested)
    img().save(nested / "000.png")


def test_compute_metrics_matches_the_repo_tool(tmp_path, monkeypatch):
    write_gallery(tmp_path)
    argv = ["--input_dir", str(tmp_path)]
    run_jax_tool("compute_metrics", argv, monkeypatch)
    with open(tmp_path / "all_metric.json") as fp:
        want = json.load(fp)
    got = compute_metrics.main(argv + ["--device", "cpu"])
    with open(tmp_path / "all_metric.json") as fp:
        assert json.load(fp) == got == want
    assert got["metrics_are_proxies"] is True
    assert got["average_CLIP_score"] is None
    assert [e["n_frames"] for e in got["per_prompt"]] == [2, 1, 2]


# the CLIP towers of the score at reduced widths: the image embedding as
# wide as the text tower (ViT-H/14's and SD-2.1's are both 1024), the image
# tower at ViT-H/14's head width 80 and the text tower at SD-2.1's 64, the
# widths ``load_clip_towers`` infers the head counts from
CLIP_IMAGE = dict(image_size=28, patch=14, width=160, num_heads=2,
                  num_layers=2, proj_dim=128)
CLIP_TEXT = dict(width=128, num_heads=2, num_layers=2)
CLIP_TOL = 1e-5


@pytest.fixture(scope="module")
def clip_towers():
    """JAX's CLIP towers with random variables, the JAX tool's
    ``clip_encode`` arithmetic over them, and the port's towers holding the
    same weights."""
    import jax
    import jax.numpy as jnp

    from prometheus_tpu.models import CLIPImageEncoder as JaxImage
    from prometheus_tpu.models.clip_text import CLIPTextModel as JaxText
    from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
    from prometheus_torch.models import CLIPImageEncoder, CLIPTextModel
    from test_torch_layers_vae import random_params

    rng = np.random.default_rng(31)
    jenc, jtxt = JaxImage(**CLIP_IMAGE), JaxText(**CLIP_TEXT)
    with pytest.warns(UserWarning):
        jtok = JaxTokenizer()
    pimg = random_params(jenc, rng, jnp.zeros((1, 3, 224, 224)))
    ptxt = random_params(jtxt, rng, jnp.asarray(jtok(["x"])))
    fenc, ftxt = jax.jit(jenc.apply), jax.jit(jtxt.apply)

    def jax_clip_encode(pil_img, prompt, tokenizer=jtok):
        """``tools/compute_metrics.py::clip_encode`` on these towers."""
        img = np.asarray(pil_img.resize((224, 224))) / 127.5 - 1.0
        x = jnp.asarray(img.transpose(2, 0, 1))[None]
        with jax.default_matmul_precision("float32"):
            fi = fenc(pimg, x)
            ft = ftxt(ptxt, jnp.asarray(tokenizer([prompt])))
        ft = ft.mean(axis=1)
        a = fi / jnp.linalg.norm(fi, axis=-1, keepdims=True)
        b = ft / jnp.linalg.norm(ft, axis=-1, keepdims=True)
        return float((a * b).sum(-1).mean())

    image, text = CLIPImageEncoder(**CLIP_IMAGE), CLIPTextModel(**CLIP_TEXT)
    assert load_jax_params(image, pimg) == []
    assert load_jax_params(text, ptxt) == []
    return jax_clip_encode, image.eval(), text.eval()


def fixed_tokens(prompts):
    """CLIP-shaped ids ``(B, 77)`` (start, one id a word, end, end-padded)
    from the words' CRC-32: the same ids in every process, where the
    fallback tokenizer's ``hash`` is salted per process."""
    out = np.full((len(prompts), 77), 49407, dtype=np.int32)
    for i, prompt in enumerate(prompts):
        ids = [49406] + [zlib.crc32(w.encode()) % 49406
                         for w in prompt.split()] + [49407]
        out[i, :len(ids)] = ids
    return out


def test_compute_metrics_clip_score(clip_towers):
    """``clip_scorer`` (224^2 resize, /127.5 - 1, NCHW, the image
    embedding against the token-mean text embedding) against the JAX
    tool's ``clip_encode`` on the same towers and the same fixed token ids,
    to ``CLIP_TOL``."""
    jax_clip_encode, image, text = clip_towers
    score = compute_metrics.clip_scorer(image, text, fixed_tokens,
                                        torch.device("cpu"))
    rng = np.random.default_rng(32)
    got, want = [], []
    for hw in ((40, 40), (64, 48)):
        pil = Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8))
        for prompt in ("a red car", "a wooden cabin in the snow"):
            got.append(score(pil, prompt))
            want.append(jax_clip_encode(pil, prompt, fixed_tokens))
    np.testing.assert_allclose(got, want, rtol=0, atol=CLIP_TOL)
    # the four scores differ: both the image and the text reach the score
    assert np.ptp(want) > 1e3 * CLIP_TOL


@pytest.mark.parametrize("source", ["file", "bundle"])
def test_compute_metrics_clip_towers_from_disk(tmp_path, clip_towers,
                                               source):
    """``--clip_ckpt``: a torch file of ``clip_image`` / ``clip_text``
    state dicts, or a release bundle directory (its MV-LDM text tower)
    beside ``--clip_image_ckpt``. ``load_clip_towers`` rebuilds both towers
    at their widths with equal weights, and the CLI's per-prompt CLIP
    scores equal the JAX tool's arithmetic on the gallery's frames."""
    from prometheus_torch.checkpoint import write_bundle

    jax_clip_encode, image, text = clip_towers
    if source == "file":
        ckpt = str(tmp_path / "clip.pt")
        torch.save({"clip_image": image.state_dict(),
                    "clip_text": text.state_dict()}, ckpt)
        extra = []
    else:
        ckpt = str(tmp_path / "bundle")
        mv = {f"text_encoder.{k}": v for k, v in text.state_dict().items()}
        mv["unet.w"] = torch.zeros(2)      # another part of the tower
        write_bundle(ckpt, {"mvldm": mv, "gsdecoder": {}, "traj": {}}, {})
        image_file = str(tmp_path / "clip_image.pt")
        torch.save(image.state_dict(), image_file)
        extra = ["--clip_image_ckpt", image_file]
    got_image, got_text = compute_metrics.load_clip_towers(
        ckpt, extra[-1] if extra else None, torch.device("cpu"))
    for want_mod, got_mod in ((image, got_image), (text, got_text)):
        want_sd, got_sd = want_mod.state_dict(), got_mod.state_dict()
        assert list(got_sd) == list(want_sd)
        for k, v in want_sd.items():
            assert torch.equal(got_sd[k], v), k
    assert compute_metrics.clip_image_widths(got_image.state_dict()) \
        == CLIP_IMAGE
    assert compute_metrics.clip_text_widths(got_text.state_dict()) == dict(
        CLIP_TEXT, vocab_size=49408, context_length=77)

    gallery = tmp_path / "gallery"
    write_gallery(gallery)
    with pytest.warns(UserWarning):
        out = compute_metrics.main(["--input_dir", str(gallery),
                                    "--clip_ckpt", ckpt, "--device", "cpu"]
                                   + extra)
    for entry in out["per_prompt"]:
        pdir = gallery / entry["prompt"].replace(" ", "_")
        frames = compute_metrics.find_frames(str(pdir), "prometheus")
        want = np.mean([jax_clip_encode(Image.open(f).convert("RGB"),
                                        entry["prompt"]) for f in frames])
        assert abs(entry["clip_score"] - want) <= CLIP_TOL
    assert out["average_CLIP_score"] == pytest.approx(
        np.mean([e["clip_score"] for e in out["per_prompt"]]), abs=1e-12)


def test_step_timer_and_memory_stats_on_cpu():
    timer = profiling.StepTimer(ema=0.5)
    x = torch.ones(64, 64)
    for _ in range(3):
        with timer.measure(sync={"y": [x @ x]}):
            x @ x
    assert timer.steps == 3 and timer.avg > 0
    # no card visible: no entry (the card run prints one per card)
    assert profiling.device_memory_stats() == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        with profiling.span("gm_ldm_step"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "prometheus.gm_ldm_step" for e in events)
