"""PyTorch port vs the JAX package: the CLIP text tower and the tokenizer.

``CLIPTextModel`` against transformers' ``FlaxCLIPTextModel`` (the JAX
package's text encoder) at hidden 32 with 2 layers, its weights carried by
``diffusion/params.py``, and against transformers' torch ``CLIPTextModel``
loaded from the same ``text_encoder/`` directory by ``load_sd_models``; the
BPE tokenizer copy against the JAX package's on its test vocabulary.
Float32 on the CPU, torch on one thread; relative L2 ≤ 1e-5 (the same math,
sums in another order; measured 1.1e-7 to 2.9e-7).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussctrl_exp_tpu.diffusion import sd_pipeline as jsd
from gaussctrl_exp_tpu.diffusion import tokenizer as jtok
from gaussctrl_exp_tpu_torch.diffusion import convert, sd_pipeline, tokenizer
from gaussctrl_exp_tpu_torch.diffusion.params import clip_params_from_flax
from gaussctrl_exp_tpu_torch.diffusion.text_encoder import CLIPTextConfig, CLIPTextModel
from torch_one_thread import one_torch_thread  # noqa: F401  (fixture)
from torch_sd_tiny import TINY_CLIP, load, rel_l2, toy_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 1e-5
REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["a bear statue, best quality, extremely detailed", "The Bear AND the statue",
           "longbody, lowres, bad anatomy, 3 hands!", "", "tu sta ëè 🐻"]


@pytest.fixture(scope="module")
def flax_clip():
    from transformers import CLIPTextConfig as HFConfig
    from transformers import FlaxCLIPTextModel

    return FlaxCLIPTextModel(HFConfig(**TINY_CLIP), seed=1)


def test_clip_text_model_matches_flax(flax_clip):
    ids = np.random.default_rng(0).integers(0, TINY_CLIP["vocab_size"], size=(3, 77)).astype(np.int32)
    want = np.asarray(flax_clip(input_ids=ids, params=flax_clip.params).last_hidden_state)
    port = load(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), clip_params_from_flax(flax_clip.params))
    got = port(torch.as_tensor(ids))
    assert got.shape == (3, 77, 32)
    assert rel_l2(got, want) <= REL


def test_clip_is_causal(flax_clip):
    """Changing token 40 leaves the hidden states of tokens 0..39 as they were."""
    port = load(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), clip_params_from_flax(flax_clip.params))
    ids = torch.randint(0, 500, (1, 77), generator=torch.Generator().manual_seed(2))
    other = ids.clone()
    other[0, 40] = (ids[0, 40] + 1) % 500
    a, b = port(ids), port(other)
    assert torch.equal(a[0, :40], b[0, :40]) and not torch.equal(a[0, 40:], b[0, 40:])


def test_encode_prompt_ids_matches_jax(flax_clip):
    """The pipelines' prompt encoding, tokenizer and tower together."""
    jm = type("M", (), {})()
    jm.text_encoder, jm.text_params = flax_clip, flax_clip.params
    vocab, merges = jtok.make_test_vocab()
    ids_j = jtok.CLIPTokenizer(vocab, merges)(PROMPTS[:2])
    want = np.asarray(jsd.encode_prompt_ids(jm, ids_j))
    port = load(CLIPTextModel(CLIPTextConfig(**TINY_CLIP)), clip_params_from_flax(flax_clip.params))
    models = sd_pipeline.SDModels(None, None, None, text_encoder=port)
    ids_t = tokenizer.CLIPTokenizer(*tokenizer.make_test_vocab())(PROMPTS[:2])
    np.testing.assert_array_equal(ids_t, ids_j)
    assert rel_l2(sd_pipeline.encode_prompt_ids(models, ids_t), want) <= REL


def test_tokenizer_matches_jax():
    vocab, merges = jtok.make_test_vocab()
    assert tokenizer.make_test_vocab() == (vocab, merges)
    tj, tt = jtok.CLIPTokenizer(vocab, merges), tokenizer.CLIPTokenizer(vocab, merges)
    np.testing.assert_array_equal(tt(PROMPTS), tj(PROMPTS))
    np.testing.assert_array_equal(tt(PROMPTS, max_len=8), tj(PROMPTS, max_len=8))
    for p in PROMPTS:
        assert tt.encode(p) == tj.encode(p)
        assert tt.decode(tt.encode(p)) == tj.decode(tj.encode(p))


def test_tokenizer_from_pretrained(tmp_path):
    import json

    vocab, merges = tokenizer.make_test_vocab()
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer" / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    tt = tokenizer.CLIPTokenizer.from_pretrained(tmp_path)
    tj = jtok.CLIPTokenizer.from_pretrained(tmp_path)
    np.testing.assert_array_equal(tt(PROMPTS), tj(PROMPTS))
    with pytest.raises(FileNotFoundError):
        tokenizer.CLIPTokenizer.from_pretrained(tmp_path / "nothing")


def test_simple_tokenize_matches_jax_in_one_process():
    """The placeholder hashes words with Python's salted ``hash``: the two
    packages agree inside one process (not across processes)."""
    np.testing.assert_array_equal(sd_pipeline.simple_tokenize(PROMPTS), jsd.simple_tokenize(PROMPTS))


def test_load_sd_models_reads_a_transformers_text_encoder(tmp_path):
    """A ``text_encoder/`` saved by transformers' torch CLIPTextModel loads
    into the port without renaming and gives the same hidden states."""
    import transformers

    toy_checkpoint(tmp_path)
    cfg = transformers.CLIPTextConfig(**TINY_CLIP)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(cfg).eval()
    hf.save_pretrained(str(tmp_path / "text_encoder"))
    m = convert.load_sd_models(tmp_path, device="cpu", dtype=torch.float32)
    ids = torch.randint(0, TINY_CLIP["vocab_size"], (2, 77), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
    assert m.text_encoder.text_model.final_layer_norm.weight.dtype == torch.float32
    assert rel_l2(m.text_encoder(ids), want.numpy()) <= REL


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussctrl_exp_tpu", "transformers", "safetensors",
             "cv2", "imageio")


def test_port_imports_no_jax_transformers_or_safetensors():
    """The card has neither transformers nor safetensors, no JAX, and neither
    OpenCV nor imageio. Pillow is there (the benchmark's plain SAM reference,
    ``benchmark/reference/sam.py``, imports it on the card), so the port
    reads, writes and resizes images with it where the JAX package does."""
    files = sorted((REPO / "gaussctrl_exp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(p.relative_to(REPO)) for p in files}
    for module in ("diffusion/geometry.py", "diffusion/correspondence.py", "diffusion/triplane_attention.py",
                   "diffusion/mv_generator.py", "diffusion/inpaint.py", "experimental/noise_mask.py",
                   "ops/attention_cuda.py", "segmentation/__init__.py", "segmentation/sam.py",
                   "segmentation/lang_sam.py", "segmentation/grounding.py", "segmentation/convert.py",
                   "segmentation/clip_vision.py", "utils/resize.py", "utils/video.py",
                   "cli/viewer.py", "parallel/__init__.py", "parallel/distributed.py", "parallel/sharded.py",
                   "parallel/edit_sharded.py"):
        assert f"gaussctrl_exp_tpu_torch/{module}" in names
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
