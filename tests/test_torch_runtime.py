"""The port's run-time layer against the JAX package, on the CPU: the run
config (``load_run_config`` / ``inherit_ckpt_args``) field for field, the
caption metrics (BLEU, CIDEr-D, ROUGE-L) within 1e-12, TensorBoard event
files byte for byte (wall time and host fixed), the tools' ``id2lineidx``
and ``filter-videos`` outputs byte for byte on the fixture TSV,
``build-vocab``'s by what one run of the trainer fixes, and the CLI's
task registry name for name.  Nothing here trains a model."""
import dataclasses
import json
import os
import pickle
import random
import shutil
import socket
import time

import pytest

from lavender_tpu import config as jcfg
from lavender_tpu_torch import config as tcfg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cli_style(data_dir="/data/toy", task="toyret", **extra):
    """A config as tests/test_cli.py writes them (tiny Swin / BERT)."""
    cfg = {
        "type": "retrieval", "task": task, "dataset": "toy",
        "data_dir": data_dir, "size_img": 64, "size_frame": 2,
        "size_txt": 8, "size_batch": 3, "size_epoch": 1, "lr": 1e-4,
        "size_option": 3, "vocab_path": f"{data_dir}/vocab.txt",
        "swin": {"embed_dim": 8, "depths": [1, 1, 1, 1],
                 "num_heads": [2, 2, 2, 2], "drop_path_rate": 0.0},
        "bert": {"vocab_size": 128, "hidden_size": 32,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "intermediate_size": 64, "max_position_embeddings": 64},
    }
    cfg.update(extra)
    return cfg


def _reference_style():
    """A reference ``_args/args_*.json`` recipe (utils/args.py key names)."""
    return {"type": "qaoe", "dataset": ["msrvtt", "tgif"], "task": "msrvtt-qa",
            "size_img": 384, "vis_backbone_size": "large", "size_frame": 5,
            "size_txt": 40, "size_epoch": 10, "size_batch": 6,
            "lr": 2e-5, "decay": 1e-3, "vis_backbone_lr_mul": 0.5,
            "max_grad_norm": 1.0, "temp": 0.07, "p_mask": 0.2,
            "img_transform": ["vid_rand_crop"], "data_ratio": 0.5,
            "size_vocab": 1500, "multi_clip_testing": True, "tp": 2,
            "enable_task_token": True, "seed": 7, "dtype": "bfloat16"}


def _case(name, tmp_path):
    if name == "cli":
        return _cli_style()
    if name == "cli-prompt":
        return _cli_style(enable_prompt=True, size_vocab=3, task="toyoets")
    raw = _reference_style()
    if name == "ckpt-dir":
        # the checkpoint's directory carries its training run's args.json
        d = tmp_path / "run"
        d.mkdir()
        with open(d / "args.json", "w") as f:
            json.dump({"vis_backbone_size": "base", "swinbert": True,
                       "bert": {"num_hidden_layers": 6},
                       "swin": {"depths": [2, 2, 6, 2]},
                       "max_size_frame": 8, "enable_prompt": True,
                       "size_frame": 9, "size_img": 224}, f)
        raw["path_ckpt"] = str(d / "ckpt_violet_3.pt")
    if name == "ckpt-dir-eval":  # size_epoch 0 also inherits the shapes
        raw = _case("ckpt-dir", tmp_path)
        raw["size_epoch"] = 0
    return raw


@pytest.mark.parametrize("name", ["cli", "cli-prompt", "reference",
                                  "ckpt-dir", "ckpt-dir-eval"])
def test_run_config_equals_jax(name, tmp_path):
    raw = _case(name, tmp_path)
    assert tcfg.inherit_ckpt_args(dict(raw)) == jcfg.inherit_ckpt_args(
        dict(raw))
    want = jcfg.load_run_config(dict(raw))
    got = tcfg.load_run_config(dict(raw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # and from a file
    path = tmp_path / "args.json"
    path.write_text(json.dumps(raw))
    assert dataclasses.asdict(tcfg.load_run_config(str(path))) == \
        dataclasses.asdict(want)


def test_run_config_defaults_equal_jax():
    assert dataclasses.asdict(tcfg.RunConfig()) == dataclasses.asdict(
        jcfg.RunConfig())


def _captions(seed):
    rs = random.Random(seed)
    words = ["a", "man", "woman", "dog", "is", "playing", "the", "guitar",
             "on", "stage", "runs", "across", "street", "cat", "sits", "."]
    sent = lambda: " ".join(rs.choice(words)
                            for _ in range(rs.randint(3, 11)))
    cands = {f"v{i}": sent() for i in range(12)}
    refs = {k: [sent() for _ in range(rs.randint(1, 4))] for k in cands}
    refs["v0"] = [cands["v0"]]  # one exact match
    cands["v1"] = ""  # one empty candidate
    return cands, refs


@pytest.mark.parametrize("seed", [0, 1])
def test_caption_metrics_equal_jax(seed):
    from lavender_tpu.utils import metrics as jm
    from lavender_tpu_torch.utils import metrics as tm
    cands, refs = _captions(seed)
    want = jm.coco_caption_metrics(cands, refs)
    got = tm.coco_caption_metrics(cands, refs)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert want["CIDEr"] > 0 and want["Bleu_1"] > 0


def test_tensorboard_events_equal_jax(tmp_path, monkeypatch):
    from lavender_tpu.utils import tb as jtb
    from lavender_tpu_torch.utils import tb as ttb
    monkeypatch.setattr(time, "time", lambda: 1234567.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    files = []
    for mod, sub in ((jtb, "jax"), (ttb, "port")):
        w = mod.TensorboardLogger(str(tmp_path / sub))
        w.add_scalar("ls_tr", 0.5)
        w.step()
        w.add_scalars({"ac_vl": 0.25, "ac_ts": 1, "skip": "n/a"},
                      prefix="ep", step=7)
        w.set_step(-3)
        w.add_scalar("neg", -1.5)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and len(got) > 100


def test_tools_id2lineidx_equals_jax(tmp_path):
    from lavender_tpu.cli import tools as jtools
    from lavender_tpu_torch.cli import tools as ttools
    for sub, mod in (("jax", jtools), ("port", ttools)):
        d = tmp_path / sub
        d.mkdir()
        # no .lineidx beside the copy: the tool writes it first
        shutil.copy(os.path.join(DATA, "img_fixture.tsv"), d / "img.tsv")
        mod.main(["id2lineidx", "--tsv", str(d / "img.tsv")])
    for name in ("img.lineidx", "img.id2lineidx.pkl"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    with open(tmp_path / "port" / "img.id2lineidx.pkl", "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(DATA, "img_fixture.id2lineidx.pkl"), "rb") as f:
        assert got == pickle.load(f)


def test_tools_build_vocab_like_jax(tmp_path):
    """The HF WordPiece trainer breaks ties in another order on every run
    (the JAX tool's own runs disagree byte for byte), so the two tools'
    vocabularies are held to what a run fixes: the same size, the special
    tokens first, the same single characters, and every corpus word
    tokenized without [UNK] by the port's tokenizer."""
    pytest.importorskip("tokenizers")
    from lavender_tpu.cli import tools as jtools
    from lavender_tpu_torch.cli import tools as ttools
    from lavender_tpu_torch.data.tokenizer import BertTokenizer
    with open(os.path.join(DATA, "txt_retrieval.json")) as f:
        items = json.load(f)
    lines = []
    for split in items.values():
        for it in split:
            cap = it["caption"]
            lines.extend(cap if isinstance(cap, list) else [cap])
    (tmp_path / "corpus.txt").write_text("\n".join(lines) * 3)
    vocabs = []
    for sub, mod in (("jax", jtools), ("port", ttools)):
        out = tmp_path / f"vocab_{sub}.txt"
        mod.main(["build-vocab", "--corpus", str(tmp_path / "corpus*.txt"),
                  "--size", "200", "--output", str(out)])
        vocabs.append(out.read_text().split("\n"))
    want, got = vocabs
    assert len(got) == len(want) > 100
    assert got[:5] == want[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                   "[MASK]"]
    chars = lambda v: {t for t in v if len(t.replace("##", "")) == 1}
    assert chars(got) == chars(want)
    tok = BertTokenizer(str(tmp_path / "vocab_port.txt"))
    for line in lines:
        assert "[UNK]" not in tok.tokenize(line), line


def test_tools_filter_videos_equals_jax(tmp_path):
    from lavender_tpu.cli import tools as jtools
    from lavender_tpu_torch.cli import tools as ttools
    txt = {"train": [{"video": f"video{i}"} for i in range(8)],
           "test": [{"video": "video0"}]}
    other = {"test": [{"video": "video3"}, {"video": "video5"}]}
    (tmp_path / "txt.json").write_text(json.dumps(txt))
    (tmp_path / "other.json").write_text(json.dumps(other))
    for sub, mod in (("jax", jtools), ("port", ttools)):
        mod.main(["filter-videos", "--txt", str(tmp_path / "txt.json"),
                  "--test-jsons", str(tmp_path / "other.json"),
                  "--output", str(tmp_path / f"{sub}.json")])
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert len(json.loads(got)["train"]) == 6


def test_task_registry_equals_jax():
    from lavender_tpu.cli import main as jmain
    from lavender_tpu_torch.cli import main as tmain
    assert sorted(tmain.TASKS) == sorted(jmain.TASKS)
    assert len(tmain.TASKS) == 17


def test_freeze_mask_and_profiling_helpers():
    """``freeze_mask`` by regex over named parameters and
    ``zero_frozen_grads``; the memory string without a GPU."""
    import torch
    from lavender_tpu_torch.utils import misc, profiling
    model = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Linear(3, 1))
    mask = misc.freeze_mask(model, [r"^0\."])
    assert mask == {"0.weight": False, "0.bias": False, "1.weight": True,
                    "1.bias": True}
    model(torch.ones(4, 2)).sum().backward()
    misc.zero_frozen_grads(model, mask)
    assert float(model[0].weight.grad.abs().sum()) == 0.0
    assert float(model[1].weight.grad.abs().sum()) > 0.0
    assert profiling.humanbytes(3 * 1024 ** 3) == "3.00 GB"
    assert profiling.log_memory_string(5, 1e-4).startswith(
        "step: 5, lr_swin: 1.00e-04, ")
