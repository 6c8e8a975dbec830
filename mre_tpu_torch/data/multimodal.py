"""Host-side multimodal data pipeline, evaluation form (port of mre_tpu/data/multimodal.py).

Text is tokenized once per entity / relation into dense int32 arrays with
the hashing tokenizer (1.0 = PAD masks). Entity images are decoded, cropped
by ``random_resized_crop`` from a per-entity seed, resized bicubically and
normalized; entities without an image get the reference's scaled-Xavier
noise placeholder. Decoding and resizing use ``data/images.py`` (numpy +
zlib) and reproduce the JAX package's PIL pipeline bit for bit.

This slice ports the evaluation batches (``generate_batch`` with eval
seeds). Training augmentation (per-step seeds, flips), the pre-decoded image
cache and HuggingFace tokenizers come with the training slice.
"""

from __future__ import annotations

import dataclasses
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
        self.tokenizer = HashingTokenizer(cfg.vocab_size)
        self.vocab_size = self.tokenizer.vocab_size

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

    @staticmethod
    def _placeholder(rng: np.random.Generator, s: int) -> np.ndarray:
        """Scaled-Xavier noise image for text-only entities
        (module/data.py:286-290): U(±1/sqrt(s)) × 10."""
        limit = 1.0 / np.sqrt(s)
        return (rng.uniform(-limit, limit, (s, s, 3)) * 10.0).astype(np.float32)

    def entity_images(self, node_ids: np.ndarray, workers: int = 8) -> np.ndarray:
        """Evaluation images [n, S, S, 3] float32. Each entity's crop comes
        from a seed derived from its id, so repeated sweeps are identical."""
        cfg = self.config
        node_ids = np.asarray(node_ids)
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        seeds = node_ids.astype(np.int64) * 2654435761 + cfg.seed
        out = np.empty((len(node_ids), cfg.image_size, cfg.image_size, 3), np.float32)

        def work(k):
            i = node_ids[k]
            rng = np.random.default_rng(seeds[k])
            if self.has_image[i]:
                img = random_resized_crop(rng, decode_png(self.images[i]), cfg.image_size)
                out[k] = (img.astype(np.float32) / 255.0 - mean) / std
            else:
                out[k] = self._placeholder(rng, cfg.image_size)

        if workers > 1 and len(node_ids) > 4:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(work, range(len(node_ids))))
        else:
            for k in range(len(node_ids)):
                work(k)
        return out

    def generate_batch(self, node_ids, rel_ids) -> dict:
        """Evaluation batch (the JAX ``generate_batch(..., train=False)``,
        reference MMKGDataset.generate_batch, module/data.py:272-314)."""
        node_ids = np.asarray(node_ids, np.int32)
        rel_ids = np.asarray(rel_ids, np.int32)
        batch = {
            "text": self.text_ids[node_ids],
            "text_padding_mask": self.text_mask[node_ids],
            "rel_des": self.rel_ids[rel_ids],
            "rel_des_padding_mask": self.rel_mask[rel_ids],
        }
        if not self.config.text_only:
            batch["image"] = self.entity_images(node_ids)
        if self.config.image_only:
            batch.pop("text", None)
            batch.pop("text_padding_mask", None)
        return batch
