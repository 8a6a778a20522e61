"""The port's zero-shot and retrieval scoring (``pipeline/zeroshot.py``, a
copy of the JAX package's pure-numpy module) against the JAX module, and
the port's ``inference_zeroshot_cls`` CLI against the JAX package's script
on word embeddings, class embeddings, vocabularies and predictions written
in code. Exact: both are the same numpy arithmetic."""

import json
import os
import runpy
import sys

import numpy as np
import pytest

from aicity_action_tpu.pipeline import zeroshot as jzs
from aicity_action_tpu_torch.pipeline import zeroshot as tzs
from aicity_action_tpu_torch.tools import inference_zeroshot_cls
from torch_port_helpers import REPO
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

WORDS = ["person", "drinking", "texting", "phone", "eating", "car",
         "reaching", "talking", "driver", "water", "food", "hand"]
DIM = 12
QUERIES = ["A person texting on the phone!", "eating food in the car",
           "the driver, talking", "unknown words only", ""]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Word vectors, two datasets' class names / embeddings / predictions,
    the dataset config and the video ids, written with numpy from a
    seed."""
    d = tmp_path_factory.mktemp("zeroshot")
    rng = np.random.default_rng(0)
    emb = {w: rng.standard_normal(DIM).astype(np.float32) for w in WORDS}
    with open(d / "words.txt", "w") as f:
        for w, v in emb.items():
            f.write(w + " " + " ".join(f"{x:.6f}" for x in v) + "\n")
    classes = {"kinetics": ["drinking water", "texting", "eating food",
                            "talking on the phone"],
               "aicity": ["phone call", "hand reaching", "driver eating"]}
    conf = {"dataset_class_embeddings": {}, "dataset_vocab_files": {},
            "dataset_pred_files": {}}
    words = tzs.load_word_embeddings(str(d / "words.txt"))
    for ds, names in classes.items():
        with open(d / f"{ds}_vocab.txt", "w") as f:
            f.write("\n".join(names) + "\n")
        np.save(d / f"{ds}_emb.npy", np.stack([
            tzs.embed_query(tzs.query_words(n), words, DIM) for n in names]))
        np.save(d / f"{ds}_pred.npy",
                rng.random((6, len(names))).astype(np.float32))
        conf["dataset_class_embeddings"][ds] = f"{ds}_emb.npy"
        conf["dataset_vocab_files"][ds] = f"{ds}_vocab.txt"
        conf["dataset_pred_files"][ds] = f"{ds}_pred.npy"
    with open(d / "datasets.json", "w") as f:
        json.dump(conf, f)
    with open(d / "videos.txt", "w") as f:
        f.write("\n".join(f"video_{i}" for i in range(6)) + "\n")
    return d


def test_scoring_functions_equal_jax(tree):
    path = str(tree / "words.txt")
    got, want = tzs.load_word_embeddings(path), jzs.load_word_embeddings(path)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    embs = {ds: np.load(tree / f"{ds}_emb.npy")
            for ds in ("kinetics", "aicity")}
    names = {ds: (tree / f"{ds}_vocab.txt").read_text().splitlines()
             for ds in embs}
    preds = {ds: np.load(tree / f"{ds}_pred.npy") for ds in embs}
    ids = [f"video_{i}" for i in range(6)]
    for q in QUERIES:
        assert tzs.query_words(q) == jzs.query_words(q)
        assert tzs.filter_query(q) == jzs.filter_query(q)
        qe = tzs.embed_query(tzs.query_words(q), got, DIM)
        assert np.array_equal(qe, jzs.embed_query(jzs.query_words(q), want,
                                                  DIM))
        for min_simi, top_k in ((0.6, 10), (0.0, 3), (-1.0, 10)):
            kept, weights = tzs.class_weights_for_query(
                qe, embs, names, min_simi=min_simi, top_k_cls=top_k)
            jkept, jweights = jzs.class_weights_for_query(
                qe, embs, names, min_simi=min_simi, top_k_cls=top_k)
            assert kept == jkept
            assert all(np.array_equal(weights[k], jweights[k])
                       for k in weights)
            fused = tzs.fuse_predictions(preds, weights)
            assert np.array_equal(fused, jzs.fuse_predictions(preds,
                                                              jweights))
            assert tzs.rank_videos(fused, ids, 4) == \
                jzs.rank_videos(fused, ids, 4)
        # text -> video retrieval over saved features, one encoder closure
        feats = np.random.default_rng(len(q)).standard_normal((6, DIM))

        def encode(text):
            return tzs.embed_query(tzs.query_words(text), got, DIM) + 0.1

        assert tzs.retrieve_videos_by_text(q, feats, ids, encode, 3) == \
            jzs.retrieve_videos_by_text(q, feats, ids, encode, 3)


@pytest.mark.parametrize("query", QUERIES[:3])
def test_zeroshot_cli_equals_the_jax_script(tree, tmp_path, monkeypatch,
                                            query):
    d = str(tree)
    args = [query, os.path.join(d, "datasets.json"), d, d,
            os.path.join(d, "words.txt"), d, os.path.join(d, "videos.txt")]
    flags = ["--emb_dim", str(DIM), "--min_simi", "0.3", "--top_k_cls", "3",
             "--top_k_videos", "4"]
    ranked = inference_zeroshot_cls.main(
        args + [str(tmp_path / "port.txt")] + flags)
    monkeypatch.setattr(sys, "argv", ["inference_zeroshot_cls.py"] + args
                        + [str(tmp_path / "jax.txt")] + flags)
    runpy.run_path(os.path.join(REPO, "tools", "inference_zeroshot_cls.py"),
                   run_name="__main__")
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert len(ranked) == 4 == len(got.splitlines())
    assert got.splitlines()[0] == f"{ranked[0][0]} {ranked[0][1]:.6f}"
