"""The port's CLI (``lavender_tpu_torch.cli.main``) on the CPU: each of the
17 tasks through ``main([..., "--device", "cpu"])`` on a demo dataset in
the reference layout at the tiny size of tests/test_cli.py (Swin embed 8,
depths 1/1/1/1, BERT 32 wide and 2 layers, 64 px, 2 frames), and the
slice against the JAX CLI once: both run ``retrieval_mlm`` for one epoch
from the same reference-layout ``.pt`` (``--path_ckpt``, so the zero-shot
eval runs too) with every dropout and drop-path rate at 0.

The demo clips have as many frames as a clip takes (2), so the train
sampler draws no random frames and both CLIs see the same batches; the
JAX side runs on one device (its CLI's mesh off: the conftest's 8 virtual
devices would make it dp=8 with per-device batches) on its module math
("xla"), the port on its default route."""
import base64
import glob
import io
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from lavender_tpu_torch.data.tokenizer import build_test_vocab
from lavender_tpu_torch.data.tsv import TSVFile, tsv_writer

N_VID, N_FRAMES = 6, 2


def _jpeg_b64(rs, size=48):
    from PIL import Image
    arr = (rs.rand(size, size, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def _entries(split, make):
    return [make(i) for i in range(24 if split == "train" else N_VID)]


def build_demo_data_dir(d):
    """tests/test_cli.py's demo dataset (6 videos, 24 train and 6 val /
    test items per task) with 2 frames a video, plus the FiB, QA-OE
    classifier and pretraining shards its tests add."""
    rs = np.random.RandomState(0)
    rows = [[f"vid{i}", "{}"] + [_jpeg_b64(rs) for _ in range(N_FRAMES)]
            for i in range(N_VID)]
    tsv_writer(rows, str(d / "img_toy.tsv"))
    with open(d / "img_toy.lineidx") as f:
        offsets = [int(l) for l in f]
    with open(d / "img_toy.id2lineidx.pkl", "wb") as f:
        pickle.dump({f"vid{i}": offsets[i] for i in range(N_VID)}, f)
    captions = ["a man is talking", "a dog is playing", "a woman is playing",
                "the cat is talking", "a person is playing", "a dog runs"]
    verbs = ["talks", "plays", "runs", "sits"]
    splits = ["train", "val", "test"]
    data = {
        "toyret": lambda i: {
            "video": f"vid{i % N_VID}",
            "caption": captions[i % N_VID] if i < N_VID
            else f"a person {verbs[i % 4]} {i}"},
        "toymc": lambda i: {
            "video": f"vid{i % N_VID}", "question": f"what is it {i}",
            "option_0": "a dog", "option_1": "a cat", "option_2": "a man",
            "answer": i % 3},
        "toyoe": lambda i: {
            "video": f"vid{i % N_VID}", "question": f"what is playing {i}",
            "answer_text": ["dog", "cat", "man"][i % 3]},
        "toyoets": lambda i: {
            "video": f"vid{i % N_VID}", "question": f"what is playing {i}",
            "answer": i % 3},
        "toyfib": lambda i: {
            "video": f"vid{i % N_VID}", "sentence": "the [MASK] is playing",
            "answer": i % 3},
    }
    for name, make in data.items():
        with open(d / f"txt_{name}.json", "w") as f:
            json.dump({s: _entries(s, make) for s in splits}, f)
    with open(d / "txt_toyfib_label2ans.json", "w") as f:
        json.dump(["dog", "cat", "man"], f)
    src = TSVFile(str(d / "img_toy.tsv"))
    tsv_writer([src.seek(i) for i in range(len(src))] * 4,
               str(d / "toypre_train_0.tsv"))
    with open(d / "txt_toypre.json", "w") as f:
        json.dump({"train": {f"vid{i}": [f"a dog is playing {i} take {j}"
                                         for j in range(4)]
                             for i in range(N_VID)}}, f)
    vocab = build_test_vocab()
    with open(d / "vocab.txt", "w") as f:
        for tok_ in sorted(vocab, key=vocab.get):
            f.write(tok_ + "\n")
    return d


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return build_demo_data_dir(tmp_path_factory.mktemp("dataset"))


def _config(data_dir, task, name=None, ds="toy", swin=None, bert=None,
            **extra):
    cfg = {
        "type": "retrieval", "task": task, "dataset": ds,
        "data_dir": str(data_dir), "size_img": 64, "size_frame": N_FRAMES,
        "size_txt": 8, "size_batch": 3, "size_epoch": 1, "lr": 1e-4,
        "size_option": 3,
        "vocab_path": str(data_dir / "vocab.txt"),
        "swin": dict({"embed_dim": 8, "depths": [1, 1, 1, 1],
                      "num_heads": [2, 2, 2, 2], "drop_path_rate": 0.0},
                     **(swin or {})),
        "bert": dict({"vocab_size": 128, "hidden_size": 32,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "intermediate_size": 64,
                      "max_position_embeddings": 64}, **(bert or {})),
    }
    cfg.update(extra)
    path = data_dir / f"args_{name or task}.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


_MULTI = [{"type": "retrieval", "task": "toyret", "dataset": "toy",
           "ratio": 2},
          {"type": "qamc", "task": "toymc", "dataset": "toy", "ratio": 1,
           "size_option": 3}]
# task -> (txt_{task}.json, dataset, extra config keys)
TASKS = {
    "retrieval_mlm": ("toyret", "toy", {}),
    "qamc_mlm": ("toymc", "toy", {}),
    "qaoe_mlm": ("toyoe", "toy", {}),
    "retmc_mlm": ("toymc", "toy", {}),
    "qamc_mlm_head": ("toymc", "toy", {}),
    "qaoe_mlm_fib": ("toyfib", "toy", {}),
    "caption": ("toyret", "toy", {}),
    "pretrain_mlm": ("toypre", "toypre", {}),
    "eval_retrieval": ("toyret", "toy", {}),
    "eval_retrieval_ts": ("toyret", "toy", {}),
    "multi_task_mlm": ("toyret", "toy", {"multi_task_datasets": _MULTI,
                                         "max_steps": 4, "iter_per_ep": 2}),
    "multi_task_multi_head": ("toyret", "toy", {
        "multi_task_datasets": _MULTI, "max_steps": 4, "iter_per_ep": 2}),
    "retrieval_ts": ("toyret", "toy", {}),
    "qamc_ts": ("toymc", "toy", {}),
    "qaoe_ts": ("toyoets", "toy", {"size_vocab": 3}),
    "retmc_ts": ("toymc", "toy", {}),
    "pretrain_ts": ("toypre", "toypre", {}),
}


def _finite01(values):
    return all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in values)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_every_task_runs_on_the_cpu(data_dir, tmp_path, task):
    from lavender_tpu_torch.cli.main import main
    txt, ds, extra = TASKS[task]
    out = main(["--task", task, "--config",
                _config(data_dir, txt, name=task, ds=ds, **extra),
                "--path_output", str(tmp_path), "--device", "cpu"])
    if task.startswith("eval_retrieval"):
        for split in ("val", "test"):
            assert 0.0 <= out[split]["R@1"] <= 100.0
            assert out[split]["MedR"] >= 1.0
        return
    (run,) = glob.glob(str(tmp_path / "_*"))
    with open(os.path.join(run, "args.json")) as f:
        assert json.load(f)["data"]["task"] == txt
    with open(os.path.join(run, "log.json")) as f:
        log = json.load(f)
    ckpts = sorted(glob.glob(os.path.join(run, f"ckpt_{txt}_*.pt")))
    assert ckpts, os.listdir(run)
    assert torch.load(ckpts[-1], weights_only=True)
    if task.startswith("pretrain"):
        (ls,) = log[f"{ds}-p0"]
        assert np.isfinite(ls)
    elif task.startswith("multi_task"):
        assert out.get("steps", 4) == 4
        assert _finite01(log["retrieval-toy_vl_ac"] + log["qamc-toy_vl_ac"])
    elif task == "caption":
        (ls,) = log["ls_tr"]
        assert np.isfinite(ls)
        for split in ("metrics_vl", "metrics_ts"):
            (m,) = log[split]
            assert all(np.isfinite(v) for v in m.values())
            assert m["CIDEr"] >= 0.0 and 0.0 <= m["Bleu_4"] <= 1.0
        # predictions keyed by the video ids the references use
        with open(os.path.join(run, "predictions_ep1.tsv")) as f:
            keys = sorted(line.split("\t")[0] for line in f)
        assert keys == [f"vid{i}" for i in range(N_VID)]
    else:
        (ls,) = log["ls_tr"]
        assert np.isfinite(ls)
        assert _finite01(log["ac_vl"] + log["ac_ts"])


def test_cli_needs_a_gpu_unless_told_cpu(data_dir, tmp_path, monkeypatch):
    from lavender_tpu_torch.cli.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--task", "retrieval_mlm", "--config",
              _config(data_dir, "toyret"), "--path_output", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_tensor_parallel_is_not_ported(data_dir, tmp_path):
    """``"tp": 2`` in one process: no layout of one rank holds two model
    ranks, so the CLI raises before it builds anything (the runs on four
    ranks are tests/test_torch_tensor_parallel.py's)."""
    from lavender_tpu_torch.cli.main import main
    with pytest.raises(ValueError, match="tp=2"):
        main(["--task", "retrieval_mlm", "--config",
              _config(data_dir, "toyret", name="tp2", tp=2),
              "--path_output", str(tmp_path), "--device", "cpu"])


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_logged(logger_name, fn):
    """``fn()``'s result and the lines its logger wrote."""
    handler = _Lines()
    logger = logging.getLogger(logger_name)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        return fn(), handler.lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _zero_shot(lines):
    (line,) = [l for l in lines if l.startswith("ZS:")]
    return [float(v) for v in line.split()[1:]]


NO_DROPOUT = {"hidden_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


@pytest.fixture(scope="module")
def reference_pt(data_dir):
    """A seeded model written as a reference-layout ``.pt`` (the tied MLM
    bias as ``predictions.bias``) at the tokenizer's vocabulary."""
    from lavender_tpu_torch.config import load_run_config
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    from lavender_tpu_torch.models.lavender import (LavenderModel,
                                                    init_weights)
    import dataclasses
    cfg = load_run_config(_config(data_dir, "toyret")).model
    vocab = max(cfg.bert.vocab_size,
                len(BertTokenizer(str(data_dir / "vocab.txt"))))
    cfg = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, vocab_size=vocab))
    model = init_weights(LavenderModel(cfg), torch.Generator().manual_seed(5))
    sd = dict(model.state_dict())
    sd["fc_mtm.predictions.bias"] = sd.pop("fc_mtm.predictions.decoder.bias")
    path = str(data_dir / "ckpt_violet_demo.pt")
    torch.save({"model": sd}, path)
    return path


@pytest.fixture(scope="module")
def jax_run(data_dir, reference_pt, tmp_path_factory):
    """The JAX CLI's retrieval_mlm from the ``.pt``, once, in-process:
    (log, ZS line's accuracies in percent)."""
    from lavender_tpu.cli import main as jmain
    from lavender_tpu.parallel import mesh as pmesh
    cfg = _config(data_dir, "toyret", name="parity_jax",
                  swin={"attn_impl": "xla"}, bert=NO_DROPOUT)
    out = tmp_path_factory.mktemp("jax_out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmesh, "maybe_make_mesh", lambda tp=1: None)
        log, lines = _run_logged("lavender_tpu", lambda: jmain.main(
            ["--task", "retrieval_mlm", "--config", cfg, "--path_ckpt",
             reference_pt, "--path_output", str(out)]))
    return dict(log), _zero_shot(lines)


def test_retrieval_mlm_matches_the_jax_cli(data_dir, reference_pt, jax_run,
                                           tmp_path):
    """One epoch from the same weights: ls_tr within 1e-3 relative, the
    zero-shot and epoch accuracies equal."""
    from lavender_tpu_torch.cli.main import main
    cfg = _config(data_dir, "toyret", name="parity_port", bert=NO_DROPOUT)
    log, lines = _run_logged("lavender_tpu_torch", lambda: main(
        ["--task", "retrieval_mlm", "--config", cfg, "--path_ckpt",
         reference_pt, "--path_output", str(tmp_path), "--device", "cpu"]))
    want, want_zs = jax_run
    assert any("loaded checkpoint" in l for l in lines)
    np.testing.assert_allclose(log["ls_tr"], want["ls_tr"], rtol=1e-3)
    assert _zero_shot(lines) == want_zs
    assert log["ac_vl"] == want["ac_vl"] and log["ac_ts"] == want["ac_ts"]
