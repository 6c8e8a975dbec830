"""Host-side multimodal data pipeline (port of mre_tpu/data/multimodal.py).

Text is tokenized once per entity / relation into dense int32 arrays (1.0 =
PAD masks): with a HuggingFace BERT tokenizer when ``tokenizer`` names a
local path or name (``transformers`` is imported only then), else with the
self-contained hashing tokenizer. Entity images are decoded, cropped
by ``random_resized_crop`` from a per-entity seed, resized bicubically and
normalized; entities without an image get the reference's scaled-Xavier
noise placeholder. Decoding and resizing use ``data/images.py`` (numpy +
zlib) and reproduce the JAX package's PIL pipeline bit for bit.

Evaluation batches draw each entity's crop from a seed derived from its
id, so repeated sweeps are identical. Training batches draw one seed per
slot from the store's own generator (``self._rng``, seeded from the config)
and add a 50% horizontal flip, as the JAX store does, so one seed gives the
same training images on both sides. ``entity_images`` and
``generate_batch`` default to the training form (``train=True``), as in
JAX.

``precompute_image_cache`` decodes every entity image once into a uint8
cache ``round(image_size · margin)`` px wide; from then on
``entity_images`` crops a fixed-size random window from it (and flips it in
training) instead of decoding, for training and evaluation alike, draw for
draw as the JAX store does (mre_tpu/data/multimodal.py:199-238, 271-294),
on the thread pool the decoding path uses.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from mre_tpu_torch.data.images import decode_png, resize_bicubic

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CC12M_MEAN = (0.5762, 0.5503, 0.5213)
CC12M_STD = (0.3207, 0.3169, 0.3307)


class HashingTokenizer:
    """Deterministic whitespace+hash tokenizer (BERT-shaped output)."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def __call__(self, text: str, max_length: int):
        ids = np.zeros(max_length, np.int32)
        mask = np.ones(max_length, np.float32)      # 1.0 = PAD (ref convention)
        words = text.split()[:max_length]
        for i, w in enumerate(words):
            h = 2166136261                           # FNV-1a, stable across processes
            for ch in w.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids[i] = 1 + h % (self.vocab_size - 1)
            mask[i] = 0.0
        return ids, mask


class HFTokenizer:
    def __init__(self, name_or_path: str, vocab_size: int | None = None):
        import transformers

        self.tok = transformers.BertTokenizer.from_pretrained(name_or_path)
        self.vocab_size = self.tok.vocab_size

    def __call__(self, text: str, max_length: int):
        enc = self.tok(text, padding="max_length", truncation=True,
                       max_length=max_length, return_tensors="np",
                       add_special_tokens=False)
        if enc["input_ids"][0].size == 0:
            return np.zeros(max_length, np.int32), np.ones(max_length, np.float32)
        ids = enc["input_ids"][0].astype(np.int32)
        mask = 1.0 - enc["attention_mask"][0].astype(np.float32)
        return ids, mask


def make_tokenizer(name_or_path: str | None = None, vocab_size: int = 30522):
    """The HF tokenizer ``name_or_path`` names; on a load failure a warning
    and the hashing tokenizer, as the JAX package does."""
    if name_or_path:
        try:
            return HFTokenizer(name_or_path)
        except Exception as e:
            import warnings
            warnings.warn(
                f"tokenizer {name_or_path!r} failed to load ({e!r}); falling "
                "back to the hashing tokenizer — token ids will NOT match a "
                "pretrained vocabulary", stacklevel=2)
    return HashingTokenizer(vocab_size)


def random_resized_crop(rng: np.random.Generator, img: np.ndarray, out_size: int,
                        scale=(0.2, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """RandomResizedCrop + bicubic resize with torchvision semantics; the
    same draws from ``rng`` as mre_tpu/data/multimodal.py:103-136."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.integers(0, h - ch + 1)
            left = rng.integers(0, w - cw + 1)
            crop = img[top:top + ch, left:left + cw]
            break
    else:
        # torchvision fallback: clamp the aspect ratio to the bounds, center-crop
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw = w
            ch = int(round(cw / ratio[0]))
        elif in_ratio > ratio[1]:
            ch = h
            cw = int(round(ch * ratio[1]))
        else:
            cw, ch = w, h
        top, left = (h - ch) // 2, (w - cw) // 2
        crop = img[top:top + ch, left:left + cw]
    return resize_bicubic(crop, out_size, out_size)


@dataclasses.dataclass
class MultimodalPipelineConfig:
    image_size: int = 256
    tokenizer: str | None = None
    vocab_size: int = 30522
    tokenizer_max_length: int = 64
    unpaired_tokenizer_max_length: int = 320
    image_normalization: str = "imagenet"      # imagenet | cc12m | none
    image_only: bool = False
    text_only: bool = False
    seed: int = 0


class MultimodalStore:
    """Per-entity multimodal records + per-relation descriptions, pre-tokenized."""

    def __init__(self, mm_info: Sequence, rel_descriptions: Sequence[str],
                 config: MultimodalPipelineConfig | None = None):
        self.config = config or MultimodalPipelineConfig()
        cfg = self.config
        self.tokenizer = make_tokenizer(cfg.tokenizer, cfg.vocab_size)
        self.vocab_size = self.tokenizer.vocab_size
        self._rng = np.random.default_rng(cfg.seed)

        if cfg.image_normalization == "imagenet":
            self.image_mean, self.image_std = IMAGENET_MEAN, IMAGENET_STD
        elif cfg.image_normalization == "cc12m":
            self.image_mean, self.image_std = CC12M_MEAN, CC12M_STD
        else:
            self.image_mean, self.image_std = (0, 0, 0), (1, 1, 1)

        n = len(mm_info)
        L = cfg.tokenizer_max_length
        self.has_image = np.zeros(n, bool)
        self.images: list[bytes | None] = [None] * n
        self.text_ids = np.zeros((n, L), np.int32)
        self.text_mask = np.ones((n, L), np.float32)
        for i, rec in enumerate(mm_info):
            if len(rec) == 2:
                self.images[i] = rec[0]
                self.has_image[i] = True
                text = rec[1]
            else:
                text = rec[0]
            self.text_ids[i], self.text_mask[i] = self.tokenizer(text, L)

        D = cfg.unpaired_tokenizer_max_length
        R = len(rel_descriptions)
        self.rel_ids = np.zeros((R, D), np.int32)
        self.rel_mask = np.ones((R, D), np.float32)
        for j, des in enumerate(rel_descriptions):
            self.rel_ids[j], self.rel_mask[j] = self.tokenizer(des, D)

        self.num_nodes = n
        self.num_relations = R
        self._img_cache = self._img_cache_map = self._cache_size = None

    def precompute_image_cache(self, margin: float = 1.15) -> float:
        """Decode every entity that has an image once and resize it
        bicubically into a uint8 cache of ``round(image_size · margin)`` px
        (``_img_cache``, one row per such entity; ``_img_cache_map`` maps an
        entity id to its row, −1 without an image), on 8 threads. Raises
        ``MemoryError`` above 8 GB. Returns the decode wall time in seconds."""
        s_out = int(round(self.config.image_size * margin))
        t0 = time.time()
        img_ids = np.flatnonzero(self.has_image)
        gb = len(img_ids) * s_out * s_out * 3 / 1e9
        if gb > 8.0:
            raise MemoryError(
                f"image cache would need {gb:.1f} GB ({len(img_ids)} images "
                f"at {s_out}px); disable FusionConfig.image_cache or lower "
                f"image_size for this dataset")
        cache = np.zeros((len(img_ids), s_out, s_out, 3), np.uint8)
        idx_of = np.full(self.num_nodes, -1, np.int64)
        idx_of[img_ids] = np.arange(len(img_ids))

        def work(row):
            cache[row] = resize_bicubic(decode_png(self.images[img_ids[row]]), s_out, s_out)

        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(work, range(len(img_ids))))
        self._img_cache, self._img_cache_map, self._cache_size = cache, idx_of, s_out
        return time.time() - t0

    @staticmethod
    def _placeholder(rng: np.random.Generator, s: int) -> np.ndarray:
        """Scaled-Xavier noise image for text-only entities
        (module/data.py:286-290): U(±1/sqrt(s)) × 10."""
        limit = 1.0 / np.sqrt(s)
        return (rng.uniform(-limit, limit, (s, s, 3)) * 10.0).astype(np.float32)

    def entity_images(self, node_ids: np.ndarray, train: bool = True,
                      workers: int = 8) -> np.ndarray:
        """Images [n, S, S, 3] float32: decode, random resized crop (with
        the cache: a random window of the cached image), and in training a
        50% horizontal flip. Per-slot seeds are drawn up front (thread-safe,
        order-deterministic): from ``self._rng`` in training, from the entity
        id in evaluation. Each slot's ``default_rng(seed)`` draws the crop
        (from the cache: the window's top, then its left), then the flip
        coin in training; text-only entities get the placeholder from it."""
        cfg = self.config
        node_ids = np.asarray(node_ids)
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        if train:
            seeds = self._rng.integers(0, 2**63, size=len(node_ids))
        else:
            seeds = node_ids.astype(np.int64) * 2654435761 + cfg.seed
        out = np.empty((len(node_ids), cfg.image_size, cfg.image_size, 3), np.float32)

        def work(k):
            i = node_ids[k]
            rng = np.random.default_rng(seeds[k])
            if not self.has_image[i]:
                out[k] = self._placeholder(rng, cfg.image_size)
                return
            if self._img_cache is not None:
                img = self._cached_window(rng, i)
            else:
                img = random_resized_crop(rng, decode_png(self.images[i]), cfg.image_size)
            if train and rng.random() < 0.5:
                img = img[:, ::-1]
            out[k] = (img.astype(np.float32) / 255.0 - mean) / std

        if workers > 1 and len(node_ids) > 4:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(work, range(len(node_ids))))
        else:
            for k in range(len(node_ids)):
                work(k)
        return out

    def _cached_window(self, rng: np.random.Generator, i: int) -> np.ndarray:
        """A random ``image_size`` window of entity ``i``'s cached image."""
        osz = self.config.image_size
        span = self._cache_size - osz
        top = int(rng.integers(0, span + 1)) if span > 0 else 0
        left = int(rng.integers(0, span + 1)) if span > 0 else 0
        return self._img_cache[self._img_cache_map[i], top:top + osz, left:left + osz]

    def generate_batch(self, node_ids, rel_ids, train: bool = True) -> dict:
        """Reference MMKGDataset.generate_batch semantics
        (module/data.py:272-314), pre-tokenized and batched."""
        node_ids = np.asarray(node_ids, np.int32)
        rel_ids = np.asarray(rel_ids, np.int32)
        batch = {
            "text": self.text_ids[node_ids],
            "text_padding_mask": self.text_mask[node_ids],
            "rel_des": self.rel_ids[rel_ids],
            "rel_des_padding_mask": self.rel_mask[rel_ids],
        }
        if not self.config.text_only:
            batch["image"] = self.entity_images(node_ids, train)
        if self.config.image_only:
            batch.pop("text", None)
            batch.pop("text_padding_mask", None)
        return batch

    def triple_batch(self, h_ids, r_ids, t_ids, train: bool = True) -> dict:
        """Per-triple head and tail batch of the ExpModel path
        (mre_tpu/data/multimodal.py:339-357; reference
        MultiModalKnowledgeGraphDataset.get_batch, module/data.py:516-549):
        the heads' images are drawn before the tails'."""
        h_ids = np.asarray(h_ids, np.int32)
        t_ids = np.asarray(t_ids, np.int32)
        r_ids = np.asarray(r_ids, np.int32)
        batch = {
            "text_head": self.text_ids[h_ids],
            "text_padding_mask_head": self.text_mask[h_ids],
            "text_tail": self.text_ids[t_ids],
            "text_padding_mask_tail": self.text_mask[t_ids],
            "rel_des": self.rel_ids[r_ids],
            "rel_des_padding_mask": self.rel_mask[r_ids],
        }
        if not self.config.text_only:
            batch["image_head"] = self.entity_images(h_ids, train)
            batch["image_tail"] = self.entity_images(t_ids, train)
        return batch
