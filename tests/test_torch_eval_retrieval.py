"""The port's full-corpus retrieval eval (``tasks/eval_retrieval.py``)
against the JAX package's, f32 on the CPU, on the fixture corpus of
``tests/data/make_clip_tsv.py``: 8 videos, the 16 captions of its "val"
split, clips of 2 x 64 x 64 after the Python decode path.

The model is the tiny one of tests/test_torch_tasks.py (Swin embed 8,
BERT 64 wide, 1 layer, ``attn_impl="xla"`` on both sides), its weights one
seeded numpy draw given to both through ``convert.from_flax``; the
tokenizer a small test vocabulary holding the captions' words.  Each case
runs JAX's ``full_retrieval_eval`` and the port's: the score matrix (read
where each side hands it to ``recall_at_k``) within 1e-4 absolute / 1e-3
relative, R@1/5/10 and MedR equal.  Cases: one clip, two clips
(multi-clip mean-pool), the two-tower prefilter (``rerank_top_k=3``) under
a task-token pretext, and the scalar head (``head="ts"``).
"""
import dataclasses
import json
import logging
import os.path as op
import pickle

import numpy as np
import pytest

from lavender_tpu.config import DataConfig as JDataConfig
from lavender_tpu.data.tokenizer import BertTokenizer as JTokenizer
from lavender_tpu.data.tokenizer import build_test_vocab
from lavender_tpu.tasks import common as jcommon
from lavender_tpu.tasks import eval_retrieval as jeval
from lavender_tpu_torch.data.tokenizer import BertTokenizer as TTokenizer
from lavender_tpu_torch.tasks import common
from lavender_tpu_torch.tasks import eval_retrieval as teval
from lavender_tpu_torch.tasks.task_specific import LavenderMultiHead
from tests.test_torch_convert import port_config
from tests.test_torch_tasks import (CFG, HEADS, _draw_params, _jax_model,
                                    _port_model)

DATA = op.join(op.dirname(op.abspath(__file__)), "data")


@pytest.fixture(scope="module")
def corpus():
    with open(op.join(DATA, "img_fixture.id2lineidx.pkl"), "rb") as f:
        id2lineidx = pickle.load(f)
    with open(op.join(DATA, "txt_retrieval.json")) as f:
        txt = json.load(f)["val"]
    words = sorted({w.strip(".") for it in txt for w in it["caption"].split()})
    vocab = build_test_vocab(words)
    return id2lineidx, txt, vocab


def _datasets(corpus, multi_clip):
    id2lineidx, txt, vocab = corpus
    jc = JDataConfig(data_dir=DATA, dataset="fixture", task="retrieval",
                     size_img=64, size_frame=2, size_txt=12)
    path = op.join(DATA, "img_fixture.tsv")
    kw = {"multi_clip": multi_clip, "max_clips": 2}
    return (jeval.RetrievalEvalDataset(jc, JTokenizer(vocab), "val", path,
                                       id2lineidx, txt, **kw),
            teval.RetrievalEvalDataset(port_config(jc), TTokenizer(vocab),
                                       "val", path, id2lineidx, txt, **kw))


@pytest.fixture(scope="module")
def models():
    m = _jax_model()
    params = _draw_params(m)
    return m, params, _port_model(params, LavenderMultiHead, heads=HEADS)


def _capture(monkeypatch, module):
    """The score matrix each side hands to ``recall_at_k``."""
    seen = []
    real = module.recall_at_k

    def spy(score, gt):
        seen.append((np.array(score), np.array(gt)))
        return real(score, gt)
    monkeypatch.setattr(module, "recall_at_k", spy)
    return seen


@pytest.mark.parametrize("multi_clip,rerank,head,pretext", [
    (False, 0, "mlm", False), (True, 0, "mlm", False),
    (False, 3, "mlm", True), (True, 0, "ts", False)],
    ids=["one-clip", "multi-clip", "rerank-pretext", "ts-head"])
def test_full_retrieval_eval_matches_jax(multi_clip, rerank, head, pretext,
                                         corpus, models, monkeypatch):
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    m, params, model = models
    jd, td = _datasets(corpus, multi_clip)
    jp = tp = None
    if pretext:
        pcfg = dataclasses.replace(CFG, enable_task_token=True)
        jp = jcommon.make_pretext_fn(m, pcfg, "vtm")
        tp = common.make_pretext_fn(port_config(pcfg), "vtm")
    jseen, tseen = _capture(monkeypatch, jeval), _capture(monkeypatch, teval)
    kw = {"batch_size": 4, "pair_batch": 24, "rerank_top_k": rerank,
          "head": head}
    want = jeval.full_retrieval_eval(m, {"params": params}, jd, pretext=jp,
                                     **kw)
    got = teval.full_retrieval_eval(model, td, pretext=tp, **kw)
    assert model.training  # the eval restores the model's mode
    (ws, wgt), (gs, ggt) = jseen[0], tseen[0]
    assert gs.shape == ws.shape == (16, 8)
    np.testing.assert_array_equal(ggt, wgt)
    np.testing.assert_allclose(gs, ws, rtol=1e-3, atol=1e-4)
    assert np.ptp(ws) > 1e-2  # the scores tell the pairs apart
    assert got == want


def test_cache_build_failure_is_logged(corpus, models, monkeypatch, caplog):
    """The serving cache is built up front (every stage, of one block
    each); one that does not build is logged with its error, and the eval
    still runs, its biases computed per call."""
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    _, _, model = models
    _, td = _datasets(corpus, False)
    model.eval()  # train() drops the cache
    want = teval.full_retrieval_eval(model, td, batch_size=8)
    assert all(layer._cache for layer in model.enc_img.swin.layers)
    model.train()

    def broken(*args):
        raise RuntimeError("no cache today")
    monkeypatch.setattr(model, "build_serving_cache", broken)
    with caplog.at_level(logging.WARNING,
                         logger="lavender_tpu_torch.tasks.eval_retrieval"):
        got = teval.full_retrieval_eval(model, td, batch_size=8)
    assert "serving cache for 2 x 64 x 64 clips not built" in caplog.text
    assert "no cache today" in caplog.text
    assert got == want
