"""Port host data pipeline vs the JAX package's (numpy + zlib vs PIL).

Everything here is integer or exactly replicated float arithmetic, so the
comparisons are exact: the port's PNG decoder and bicubic resize are
bit-equal to PIL's.
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from mre_tpu.data import fixtures as jfix
from mre_tpu.data import multimodal as jmm
from mre_tpu.data.loaders import load_zsl_dataset
from mre_tpu_torch.data import fixtures as tfix
from mre_tpu_torch.data import multimodal as tmm
from mre_tpu_torch.data.images import decode_png, encode_png, resize_bicubic

_FILES = ("entity2ids_zsl.json", "relation2ids.json", "train_tasks_zsl.json",
          "test_tasks_zsl.json", "rel2candidates_all.json", "e1rel_e2_all.json",
          "test_candidates.json", "rel_description_zsl")


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_fix"))
    tdir = str(tmp_path_factory.mktemp("port_fix"))
    kw = dict(n_ent=30, n_rel=6, n_unseen=2, triples_per_rel=12, image_size=12,
              n_candidates=22, seed=4)
    jfix.write_zsl_dataset(jdir, **kw)
    tfix.write_zsl_dataset(tdir, **kw)
    return jdir, tdir


def test_fixture_writes_same_files(fixture_dirs):
    jdir, tdir = fixture_dirs
    for name in _FILES:
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_fixture_pngs_decode_to_same_pixels(fixture_dirs):
    jdir, tdir = fixture_dirs
    with open(os.path.join(jdir, "MultiModalInfo_zsl.pkl"), "rb") as f:
        jmm_info = pickle.load(f)
    with open(os.path.join(tdir, "MultiModalInfo_zsl.pkl"), "rb") as f:
        tmm_info = pickle.load(f)
    assert len(jmm_info) == len(tmm_info)
    n_img = 0
    for a, b in zip(jmm_info, tmm_info):
        assert len(a) == len(b) and a[-1] == b[-1]          # same text
        if len(a) == 2:
            n_img += 1
            pa = np.asarray(Image.open(io.BytesIO(a[0])))
            pb = np.asarray(Image.open(io.BytesIO(b[0])))
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(decode_png(a[0]), pa)
    assert n_img > 0


def _pil_decode(data):
    img = Image.open(io.BytesIO(data))
    if img.mode in ("RGBA", "LA"):
        img = img.convert("RGBA")
        img = Image.alpha_composite(Image.new("RGBA", img.size, (255, 255, 255, 255)), img)
    return np.asarray(img.convert("RGB"))


@pytest.mark.parametrize("mode,ch", [("RGB", 3), ("RGBA", 4), ("L", 1), ("LA", 2)])
def test_decode_png_equals_pil(mode, ch):
    """PIL picks filters 0-4 adaptively per row, so every filter is hit;
    RGBA/LA also exercise the alpha blend onto white."""
    rng = np.random.default_rng(ch)
    for h, w in [(1, 1), (7, 13), (31, 5), (24, 24)]:
        arr = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        if ch == 4:
            arr[..., 3] = rng.choice([0, 1, 128, 254, 255], (h, w))
        buf = io.BytesIO()
        Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(buf, format="PNG")
        np.testing.assert_array_equal(decode_png(buf.getvalue()), _pil_decode(buf.getvalue()))


def test_encode_png_round_trips_through_pil():
    arr = np.random.default_rng(0).integers(0, 256, (9, 17, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(arr)))), arr)


@pytest.mark.parametrize("src,dst", [((12, 12), (16, 16)), ((8, 8), (256, 256)),
                                     ((64, 48), (16, 16)), ((37, 53), (29, 71)),
                                     ((5, 40), (40, 5)), ((20, 20), (20, 20))])
def test_resize_bicubic_equals_pil(src, dst):
    """Upsampling and downsampling (support scaled), bit-equal to PIL."""
    img = np.random.default_rng(sum(src + dst)).integers(0, 256, src + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, *dst), ref)


def test_store_eval_batch_equals_jax(fixture_dirs):
    jdir, _ = fixture_dirs
    data = load_zsl_dataset(jdir, mode="train")
    kw = dict(image_size=16, vocab_size=100, tokenizer_max_length=6,
              unpaired_tokenizer_max_length=10, seed=3)
    js = jmm.MultimodalStore(data["mm_info"], data["rel_des"], jmm.MultimodalPipelineConfig(**kw))
    ts = tmm.MultimodalStore(data["mm_info"], data["rel_des"], tmm.MultimodalPipelineConfig(**kw))
    nodes = np.arange(len(data["e2id"]))[::-1]
    rels = np.arange(len(data["r2id"]))
    jb = js.generate_batch(nodes, rels, train=False)
    tb = ts.generate_batch(nodes, rels)
    assert set(jb) == set(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
