"""Model FLOPs and the attention forward's bound, from shapes alone.

A matrix product of [m, k] by [k, n] counts 2·m·k·n (a multiply-add is 2).
A pass that trains counts three times its forward (the backward is twice
the forward); a pass without a gradient counts once. Elementwise work,
norms and softmax are not counted. The peaks are NVIDIA's data-sheet dense
rates of one H100 SXM at 700 W: 495 TFLOP/s for float32 (the TF32 tensor
cores: no float32-accurate implementation can beat it), 989 for bfloat16,
3.35 TB/s of HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
BYTES = {"float32": 4, "bfloat16": 2}


def encoder(b: int, n: int, d: int, depth: int, mlp: int = 4) -> float:
    """A pre-LN transformer over [b, n, d]: qkv, output projection, the MLP
    and attention's two products (Q·Kᵀ, P·V), per block."""
    dense = 2.0 * b * n * d * d * (3 + 1 + 2 * mlp)
    attn = 4.0 * b * n * n * d
    return depth * (dense + attn)


def linear(rows: int, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def image_tokens(cfg: dict) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2


def rgcn(n: int, d_in: int, d_out: int, bases: int) -> float:
    """x·basis for every node and basis, and the root product."""
    return linear(n, d_in, bases * d_out) + linear(n, d_in, d_out)


def train_step(cfg: dict, fusion: dict) -> float:
    """One fusion step: the unmasked node pass, the masked encoder, the
    decoder and its two heads, the RGCN (all trained), and the description
    pass (no gradient)."""
    nodes = fusion["batch_size"] * (1 + fusion["sample_size"])
    edges = fusion["batch_size"] * fusion["sample_size"]
    L, T, D = image_tokens(cfg), cfg["text_tokens"], cfg["description_tokens"]
    d, dd, p3 = cfg["emb_dim"], cfg["dec_emb_dim"], cfg["patch_size"] ** 2 * 3
    ki = int(L * (1 - fusion["image_mask_ratio"]))
    kt = int(T * (1 - fusion["text_mask_ratio"]))
    n_full, n_kept = 1 + L + T, 1 + ki + kt
    trained = (encoder(nodes, n_full, d, cfg["depth"])
               + linear(nodes * L, p3, d) * 2                       # both passes embed every patch
               + encoder(nodes, n_kept, d, cfg["depth"])
               + linear(nodes * n_kept, d, dd)
               + encoder(nodes, n_full, dd, cfg["dec_depth"])
               + linear(nodes * L, dd, p3) + linear(nodes * T, dd, cfg["vocab_size"])
               + rgcn(nodes, d, cfg["gcn_dim"], cfg["num_bases"]))
    return 3.0 * trained + encoder(edges, 1 + D, d, cfg["depth"])


def generator_head(cfg: dict, rows: int) -> float:
    """The generator head's three layers on ``rows`` rows: the description
    vector and the noise to the encoder's width, then to the GCN width
    twice."""
    d, g = cfg["emb_dim"], cfg["gcn_dim"]
    return linear(rows, d + cfg["noise_dim"], d) + linear(rows, d, g) + linear(rows, g, g)


def extractor(cfg: dict, rows: int) -> float:
    """One Extractor pass whose query and support are both ``rows`` entity
    pairs: four neighbour encoders over ``max_neighbor`` neighbours each,
    two entity encoders, two reshape layers, two support encoders (g → 2g
    → g) and the scores against the support mean."""
    g, h, k = cfg["gcn_dim"], cfg["gcn_dim"] // 2, cfg["max_neighbor"]
    return (4 * linear(rows * k, g, h) + 2 * 2 * linear(rows, g, h) + 2 * linear(rows, 4 * h, g)
            + 2 * (linear(rows, g, 2 * g) + linear(rows, 2 * g, g)) + linear(rows, g, 1))


def critic(cfg: dict, rows: int) -> float:
    """One critic pass: its middle layer on the rows and on the seen
    relations' centroids, the real/fake logit and the class scores."""
    g, labels = cfg["gcn_dim"], cfg["n_rel"] - cfg["n_unseen"]
    return (linear(rows, g, g) + linear(labels, g, g) + linear(rows, g, 1)
            + linear(rows, g, labels))


def serve_round(cfg: dict, n_queries: int, n_candidates: int) -> float:
    """One serving round: the entity sweep (every entity has an image or
    its noise image), the RGCN over all entities, the relation sweep, each
    unseen relation's generation (its one description through the text
    pass, the head on ``test_sample`` rows), and the Extractor's support
    encoder over every ranked pair. Rows count as the model has them: the
    rows that pad a sweep's last batch are not model work."""
    L, T, D = image_tokens(cfg), cfg["text_tokens"], cfg["description_tokens"]
    d, p3, g = cfg["emb_dim"], cfg["patch_size"] ** 2 * 3, cfg["gcn_dim"]
    ents, rels = cfg["n_ent"], cfg["n_rel"]
    return (encoder(ents, 1 + L + T, d, cfg["depth"]) + linear(ents * L, p3, d)
            + rgcn(cfg["n_ent"], d, g, cfg["num_bases"])
            + encoder(rels, 1 + D, d, cfg["depth"])
            + cfg["n_unseen"] * (encoder(1, 1 + D, d, cfg["depth"])
                                 + generator_head(cfg, cfg["test_sample"]))
            + n_queries * n_candidates * 2 * linear(1, g, 2 * g))


def gan_epoch(cfg: dict, zsl: dict) -> float:
    """One D step and one G step on ``G_batch_size · gan_batch_rela`` rows.
    Each encodes its ``gan_batch_rela`` distinct descriptions once (no
    gradient) and runs the generator head on every row. The D step: the
    head and two Extractor passes without a gradient; the critic trained
    on the real, generated and negative rows, and on the interpolates
    twice over (their input gradient, itself differentiated). The G step:
    one Extractor and one critic pass without a gradient, the head
    trained, and the critic on the generated rows with their input
    gradient. Spectral norms' power steps are not counted."""
    rela = zsl["gan_batch_rela"]
    rows = zsl["G_batch_size"] * rela
    text = encoder(rela, 1 + cfg["description_tokens"], cfg["emb_dim"], cfg["depth"])
    head, ext, crit = generator_head(cfg, rows), extractor(cfg, rows), critic(cfg, rows)
    d_step = text + head + 2 * ext + 3 * 3 * crit + 2 * 3 * crit
    g_step = text + 3 * head + ext + crit + 2 * crit
    return d_step + g_step


def attention_bound_s(b: int, h: int, n: int, hd: int, dtype: str, masked: bool) -> float:
    """The least time of one attention forward: its two products once at
    the type's tensor-core peak, or Q, K, V and the mask read once and O
    written once at HBM bandwidth, whichever is larger."""
    ops = 4.0 * b * h * n * n * hd
    nbytes = 4 * b * h * n * hd * BYTES[dtype] + (4 * b * n if masked else 0)
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
