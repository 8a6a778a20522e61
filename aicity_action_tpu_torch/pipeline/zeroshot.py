"""Zero-shot classification and text→video retrieval over saved features
(a copy of ``aicity_action_tpu/pipeline/zeroshot.py``, which is pure numpy:
the port imports nothing of the JAX package).

Re-designs `tools/inference_zeroshot_cls.py` and
`tools/inference_videotext.py`: pure-numpy scoring over precomputed
per-dataset predictions / video-text features.

- zero-shot: word-embedding similarity between the query and each dataset's
  class names builds per-dataset class-weight vectors; predictions are
  weighted and fused across datasets.
- videotext: BPE-tokenized query → text encoder → cosine ranking against
  saved video features.
"""

from __future__ import annotations

import re

import numpy as np


def load_word_embeddings(path: str) -> dict[str, np.ndarray]:
    """GloVe-style text file: ``word v1 v2 ...``."""
    vocab = {}
    with open(path) as f:
        for line in f:
            values = line.strip().split()
            vocab[values[0]] = np.asarray(values[1:], np.float32)
    return vocab


def query_words(text: str) -> list[str]:
    return [w for w in re.split(r"\W+", text.strip().lower()) if w]


def embed_query(words, word_embeddings, emb_dim: int = 300) -> np.ndarray:
    """Mean of word vectors, L2-normalized
    (inference_zeroshot_cls.py:get_embeddings)."""
    emb = np.zeros(emb_dim, np.float32)
    got = 0
    for w in words:
        if w in word_embeddings:
            emb += word_embeddings[w]
            got += 1
    if got:
        emb /= got
        n = np.linalg.norm(emb)
        if n > 0:
            emb = emb / n
    return emb


def class_weights_for_query(
    query_embedding: np.ndarray,
    dataset_class_embs: dict[str, np.ndarray],
    dataset_class_names: dict[str, list[str]],
    *,
    min_simi: float = 0.6,
    top_k_cls: int = 10,
):
    """Per-dataset class weight vectors from query-class similarity
    (inference_zeroshot_cls.py:get_dataset_cls_scores_and_weights)."""
    scored = []
    weights = {}
    for ds, embs in dataset_class_embs.items():
        sims = embs @ query_embedding
        for i, s in enumerate(sims):
            scored.append((f"{ds}_{i + 1}", float(s),
                           dataset_class_names[ds][i], ds, i))
        weights[ds] = np.zeros(len(sims), np.float32)
    scored.sort(key=lambda x: x[1], reverse=True)
    kept = [o for o in scored if o[1] >= min_simi][:top_k_cls]
    for _, simi, _, ds, cls_id in kept:
        weights[ds][cls_id] = simi
    return kept, weights


def fuse_predictions(
    dataset_preds: dict[str, np.ndarray],
    weight_matrices: dict[str, np.ndarray],
) -> np.ndarray:
    """Weighted score fusion across datasets
    (inference_zeroshot_cls.py:get_predictions)."""
    parts = [
        dataset_preds[ds] @ weight_matrices[ds] for ds in weight_matrices
    ]
    return np.stack(parts, axis=1).sum(axis=1)


def rank_videos(scores: np.ndarray, video_ids, top_k: int = 20):
    order = np.argsort(-scores)[:top_k]
    return [(video_ids[i], float(scores[i])) for i in order]


# ------------------------------------------------------------- videotext
_WORD_BLACKLIST = frozenset(
    {"a", "an", "the", "of", "in", "on", "at", "is", "are", "to"}
)


def filter_query(text: str) -> str:
    """Drop stop words (inference_videotext.py:38-51)."""
    return " ".join(w for w in query_words(text) if w not in _WORD_BLACKLIST)


def retrieve_videos_by_text(
    text: str,
    video_features: np.ndarray,
    video_ids,
    encode_text_fn,
    top_k: int = 20,
):
    """Text query → ranked videos by cosine similarity over saved features.

    ``encode_text_fn(str) -> [D]`` is the text encoder closure.
    """
    t = np.asarray(encode_text_fn(filter_query(text)), np.float32)
    t = t / max(np.linalg.norm(t), 1e-12)
    v = np.asarray(video_features, np.float32)
    v = v / np.clip(np.linalg.norm(v, axis=1, keepdims=True), 1e-12, None)
    scores = v @ t
    return rank_videos(scores, video_ids, top_k)
