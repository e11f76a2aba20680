"""The port's data plane (``lavender_tpu_torch/data/``, the task datasets)
against the JAX package's, on the CPU, on the fixture corpus of
``tests/data/make_clip_tsv.py`` (8 videos of 6-12 JPEG frames, 320 x 240).

Every comparison is exact: token ids, TSV rows and index files, uint8
pixels, sampled indices, item and batch dicts (values and dtypes), and the
state of each side's ``random.Random`` after the draw.  Each dataset pair
gets its ``rng`` seeded alike.  The native path is built from
``native/loader.cpp`` into a temporary ``build/`` (this machine's ``g++``
and libjpeg) and held against the JAX package's Python path on the same
bytes; ``native/`` must not change.
"""
import json
import os
import os.path as op
import pickle
import random

import numpy as np
import pytest
import torch

from lavender_tpu.config import DataConfig as JDataConfig
from lavender_tpu.data import composite as jcomp
from lavender_tpu.data import dataset as jds
from lavender_tpu.data import loader as jloader
from lavender_tpu.data import transforms as jtf
from lavender_tpu.data import tsv as jtsv
from lavender_tpu.data.tokenizer import BertTokenizer as JTokenizer
from lavender_tpu.data.tokenizer import build_test_vocab as jvocab
from lavender_tpu.tasks import eval_retrieval as jeval
from lavender_tpu.tasks import pretrain as jpre
from lavender_tpu.tasks import qamc as jqamc
from lavender_tpu.tasks import qaoe as jqaoe
from lavender_tpu.tasks import retmc as jretmc
from lavender_tpu.tasks import retrieval as jret
from lavender_tpu_torch.data import composite as tcomp
from lavender_tpu_torch.data import dataset as tds
from lavender_tpu_torch.data import loader as tloader
from lavender_tpu_torch.data import native
from lavender_tpu_torch.data import transforms as ttf
from lavender_tpu_torch.data import tsv as ttsv
from lavender_tpu_torch.data.tokenizer import BertTokenizer as TTokenizer
from lavender_tpu_torch.data.tokenizer import build_test_vocab as tvocab
from lavender_tpu_torch.tasks import eval_retrieval as teval
from lavender_tpu_torch.tasks import pretrain as tpre
from lavender_tpu_torch.tasks import qamc as tqamc
from lavender_tpu_torch.tasks import qaoe as tqaoe
from lavender_tpu_torch.tasks import retmc as tretmc
from lavender_tpu_torch.tasks import retrieval as tret
from tests.test_torch_convert import REPO, port_config

DATA = op.join(REPO, "tests", "data")
TSV = op.join(DATA, "img_fixture.tsv")
VOCAB = op.join(REPO, "assets", "vocab_30k.txt")
TRANSFORMS = ("vid_rand_crop", "vid_center_crop", "pad_resize",
              "img_rand_crop", "img_center_crop")


def _assert_items_equal(a, b):
    """Two item / batch dicts equal key by key, arrays in dtype too."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            x = x.numpy()
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


@pytest.fixture(scope="module")
def rows():
    with open(op.join(DATA, "img_fixture.id2lineidx.pkl"), "rb") as f:
        id2lineidx = pickle.load(f)
    with open(op.join(DATA, "txt_retrieval.json")) as f:
        txt = json.load(f)
    return id2lineidx, txt


@pytest.fixture(scope="module")
def tokenizers():
    return JTokenizer(VOCAB), TTokenizer(VOCAB)


# ---- tokenizer, TSV ----

def test_tokenizer_ids_and_encode(tokenizers, rows):
    jt, tt = tokenizers
    _, txt = rows
    corpus = [c for split in txt.values() for it in split
              for c in (it["caption"] if isinstance(it["caption"], list)
                        else [it["caption"]])]
    corpus += ["The DOG runs FAST", "don't won't it's", "café naïve zürich",
               "中国话 and english", "hello,world!how?are:you",
               "tabs\tand\nnewlines", "x" * 120, ""]
    for s in corpus:
        assert tt.tokenize(s) == jt.tokenize(s)
        assert tt.convert_tokens_to_ids(tt.tokenize(s)) == \
            jt.convert_tokens_to_ids(jt.tokenize(s))
        for n in (8, 25):
            assert tt.encode(s, padding="max_length", max_length=n,
                             truncation=True) == \
                jt.encode(s, padding="max_length", max_length=n,
                          truncation=True)
        ids = tt.encode(s)
        assert tt.decode(ids) == jt.decode(ids)
    assert (tt.cls_token_id, tt.sep_token_id, tt.pad_token_id,
            tt.mask_token_id, tt.unk_token_id, len(tt)) == \
        (jt.cls_token_id, jt.sep_token_id, jt.pad_token_id,
         jt.mask_token_id, jt.unk_token_id, len(jt))
    assert tvocab(["extra"]) == jvocab(["extra"])


def test_tsv_rows_lineidx_and_writer(tmp_path):
    jf, tf = jtsv.TSVFile(TSV), ttsv.TSVFile(TSV)
    assert tf.num_rows() == jf.num_rows() == 8
    for i in range(8):
        assert tf[i] == jf[i]
        assert tf.get_key(i) == jf.get_key(i)
    with open(op.join(DATA, "img_fixture.lineidx")) as f:
        offsets = [int(line) for line in f]
    assert tf.seek_offset(offsets[5]) == jf.seek_offset(offsets[5])
    # create_lineidx on a copy, and the writers on the same rows
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    rows = [jf[i][:4] for i in range(3)]
    jtsv.tsv_writer(rows, str(tmp_path / "a" / "x.tsv"))
    ttsv.tsv_writer(rows, str(tmp_path / "b" / "x.tsv"))
    for name in ("x.tsv", "x.lineidx", "x.lineidx.8b"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    ji = jtsv.create_lineidx(TSV, str(tmp_path / "j.lineidx"))
    ti = ttsv.create_lineidx(TSV, str(tmp_path / "t.lineidx"))
    assert open(ti, "rb").read() == open(ji, "rb").read()
    assert open(ti).read().split() == [str(o) for o in offsets]
    assert list(ttsv.tsv_reader(str(tmp_path / "b" / "x.tsv"))) == \
        list(jtsv.tsv_reader(str(tmp_path / "a" / "x.tsv")))
    seq = [(1, 2), (0, 0), (1, 0)]
    paths = [str(tmp_path / "a" / "x.tsv"), TSV]
    jc = jtsv.CompositeTSVFile(paths, seq)
    tc = ttsv.CompositeTSVFile(paths, seq)
    assert len(tc) == len(jc) == 3
    for i in range(3):
        assert tc[i] == jc[i] and tc.get_key(i) == jc.get_key(i)


# ---- transforms and indices ----

@pytest.fixture(scope="module")
def frames():
    row = jtsv.TSVFile(TSV)[2]
    return row[2:]


def test_str2img_and_every_transform(frames):
    assert ttf.decoder() in ("cv2", "pil")
    imgs = [ttf.str2img(b) for b in frames]
    for b, img in zip(frames, imgs):
        np.testing.assert_array_equal(img, jtf.str2img(b))
    tall = np.ascontiguousarray(imgs[0].transpose(1, 0, 2))  # 320 x 240
    for mode in TRANSFORMS:
        for train in (True, False):
            for clip in (imgs, [tall, tall]):
                rj, rt = random.Random(7), random.Random(7)
                want = jtf.transform_clip(clip, 32, mode, train, rj)
                got = ttf.transform_clip(clip, 32, mode, train, rt)
                assert got.dtype == want.dtype == np.uint8
                np.testing.assert_array_equal(got, want, err_msg=mode)
                assert rt.getstate() == rj.getstate()
    np.testing.assert_array_equal(ttf.normalize(imgs[0]),
                                  jtf.normalize(imgs[0]))
    np.testing.assert_array_equal(ttf.pad_to_square(tall),
                                  jtf.pad_to_square(tall))
    np.testing.assert_array_equal(ttf.resize_exact(tall, (17, 23)),
                                  jtf.resize_exact(tall, (17, 23)))


def test_temporal_and_multi_clip_indices():
    for n in range(1, 20):
        for size in (1, 2, 5, 8):
            for rand in (False, True):
                rj, rt = random.Random(n), random.Random(n)
                assert ttf.temporal_sample_indices(n, size, rand, rt) == \
                    jtf.temporal_sample_indices(n, size, rand, rj)
                assert rt.getstate() == rj.getstate()
            for max_clips in (1, 2, 8):
                assert ttf.multi_clip_indices(n, size, max_clips) == \
                    jtf.multi_clip_indices(n, size, max_clips)
    for s, e, k in ((0, 9, 1), (0, 9, 5), (3, 4, 3), (2, 11, 7)):
        assert ttf.uniform_indices(s, e, k) == jtf.uniform_indices(s, e, k)


# ---- the native path ----

@pytest.fixture(scope="module")
def native_build(tmp_path_factory):
    """The port's native library built into a temporary build/."""
    why = native.unavailable()
    if why is not None:
        pytest.skip(f"no native build here: {why}")
    before = {p: os.stat(op.join(REPO, "native", p)).st_mtime_ns
              for p in os.listdir(op.join(REPO, "native"))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("build"))
        mp.setattr(native, "_lib", None)
        so = native.build()
        yield so
    after = {p: os.stat(op.join(REPO, "native", p)).st_mtime_ns
             for p in os.listdir(op.join(REPO, "native"))}
    assert after == before  # nothing written under native/


def test_native_decode_equals_python_path(native_build, rows):
    id2lineidx, _ = rows
    assert native_build.parent == native.BUILD_DIR
    assert native_build.name.startswith("liblvt_loader_")
    nt = native.NativeTSV(TSV)
    assert native.load()._name == str(native_build)
    jf = jtsv.TSVFile(TSV)
    offsets, cols = [], []
    for v in range(8):
        off = id2lineidx[f"video{v}"]
        row = jf.seek_offset(off)
        assert nt.num_fields(off) == len(row)
        pick = jtf.temporal_sample_indices(len(row) - 2, 5, False)
        got = nt.decode_clip(off, [2 + i for i in pick], 56)
        want = jtf.transform_clip([jtf.str2img(row[2 + i]) for i in pick],
                                  56, "img_center_crop", False)
        np.testing.assert_array_equal(got, want, err_msg=f"video{v}")
        offsets.append(off)
        cols.append([2 + i for i in pick])
    batch = nt.decode_batch(offsets, np.asarray(cols), 56, n_threads=4)
    for v in range(8):
        np.testing.assert_array_equal(
            batch[v], nt.decode_clip(offsets[v], cols[v], 56))
    nt.close()


# ---- the task datasets ----

def _cfgs(**kw):
    j = JDataConfig(data_dir=DATA, dataset="fixture", task="retrieval",
                    size_img=32, size_frame=4, size_txt=12, size_option=3,
                    **kw)
    return j, port_config(j)


def _qa_items(txt):
    """QA-style items over the fixture's videos and one missing video."""
    items = []
    for i, it in enumerate(txt["val"][:5] + [{"video": "absent"}]):
        cap = it.get("caption", "a cat")
        items.append({"video": it["video"], "question": f"what is {cap}",
                      "answer": i % 3, "answer_text": cap.split()[1],
                      "sentence": f"{cap} [MASK] there",
                      **{f"option_{k}": f"{cap} {k}" for k in range(3)}})
    return items


def _pairs(tokenizers, rows, jcls, tcls, split, txt, cfgs, kw=None,
           tsv_kw=True):
    jt, tt = tokenizers
    id2lineidx, _ = rows
    (jc, tc), kw = cfgs, kw or {}
    if tsv_kw:
        jd = jcls(jc, jt, split, TSV, id2lineidx, txt, **kw)
        td = tcls(tc, tt, split, TSV, id2lineidx, txt, **kw)
    else:
        jd, td = jcls(jc, jt, split, TSV, txt, **kw), tcls(
            tc, tt, split, TSV, txt, **kw)
    return jd, td


def _compare_items(jd, td, n=None):
    assert len(td) == len(jd)
    jd.rng.seed(11)
    td.rng.seed(11)
    for i in range(len(jd) if n is None else n):
        _assert_items_equal(td[i], jd[i])
    assert td.rng.getstate() == jd.rng.getstate()


@pytest.mark.parametrize("native_path", [False, True])
def test_retrieval_dataset(native_path, tokenizers, rows, monkeypatch,
                           request):
    if native_path:
        request.getfixturevalue("native_build")
    monkeypatch.setenv("LAVENDER_NATIVE", "1" if native_path else "0")
    _, txt = rows
    transforms = ("img_rand_crop", "vid_rand_crop", "img_center_crop")
    for split in ("train", "val"):
        cfgs = _cfgs(img_transform=transforms)
        jd, td = _pairs(tokenizers, rows, jret.RetrievalDataset,
                        tret.RetrievalDataset, split, txt[split], cfgs)
        assert td.decode == ("native" if native_path
                             else f"python:{ttf.decoder()}")
        assert (jd._native is None) == (td._native is None)
        assert td.vid2idx == jd.vid2idx and td.txt == jd.txt
        _compare_items(jd, td, n=6 if split == "train" else None)


def test_qa_and_pretrain_datasets(tokenizers, rows, monkeypatch):
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    _, txt = rows
    qa = _qa_items(txt)
    cases = [(jqamc.QAMCDataset, tqamc.QAMCDataset, {}),
             (jqamc.QAMCDataset, tqamc.QAMCDataset, {"mlm": False}),
             (jqaoe.QAOEDataset, tqaoe.QAOEDataset, {}),
             (jqaoe.QAOEDataset, tqaoe.QAOEDataset, {"mlm": False}),
             (jqaoe.QAOEFibDataset, tqaoe.QAOEFibDataset, {}),
             (jretmc.RetMCDataset, tretmc.RetMCDataset, {}),
             (jretmc.RetMCDataset, tretmc.RetMCDataset, {"mlm": False}),
             (jretmc.QAMCHeadDataset, tretmc.QAMCHeadDataset, {})]
    for split, tf in (("train", ("vid_rand_crop",)), ("val", TRANSFORMS)):
        for jcls, tcls, kw in cases:
            jd, td = _pairs(tokenizers, rows, jcls, tcls, split, qa,
                            _cfgs(img_transform=tf), kw)
            _compare_items(jd, td)
        # the [MASK] positions of QA-MC and a labelled-vocab QA-OE
        for pos in ("prepend", "replace", "insert"):
            jd, td = _pairs(tokenizers, rows, jqamc.QAMCDataset,
                            tqamc.QAMCDataset, split, qa,
                            _cfgs(img_transform=tf, mask_pos=pos))
            _compare_items(jd, td, n=2)
        label2ans = {i: w for i, w in enumerate(["man", "cat", "dog"])}
        jd, td = _pairs(tokenizers, rows, jqaoe.QAOEDataset,
                        tqaoe.QAOEDataset, split, qa, _cfgs(img_transform=tf),
                        {"label2ans": label2ans})
        _compare_items(jd, td, n=3)
        ptxt = {f"video{v}": [f"caption {v}"] for v in range(0, 8, 2)}
        for name in ("", "coco"):
            jd, td = _pairs(tokenizers, rows, jpre.PretrainDataset,
                            tpre.PretrainDataset, split, ptxt,
                            _cfgs(img_transform=tf),
                            {"dataset_name": name}, tsv_kw=False)
            _compare_items(jd, td, n=3)
    # data_ratio keeps half the train videos (drawn by the unseeded rng)
    jd, td = _pairs(tokenizers, rows, jret.RetrievalDataset,
                    tret.RetrievalDataset, "train", txt["train"],
                    _cfgs(data_ratio=0.5))
    assert len({it["video"] for it in td.txt}) == \
        len({it["video"] for it in jd.txt}) == 4


@pytest.mark.parametrize("multi_clip", [False, True])
def test_retrieval_eval_dataset(multi_clip, tokenizers, rows, monkeypatch):
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    _, txt = rows
    jd, td = _pairs(tokenizers, rows, jeval.RetrievalEvalDataset,
                    teval.RetrievalEvalDataset, "val", txt["val"], _cfgs(),
                    {"multi_clip": multi_clip, "max_clips": 2})
    assert td.gt_txt2vid == jd.gt_txt2vid
    _compare_items(jd, td)
    assert td[4]["img"].shape == ((2 if multi_clip else 1), 4, 32, 32, 3)


def test_composite_caption_dataset(tokenizers, tmp_path):
    """The YAML composite over the fixture's frames and a caption TSV
    (plain and, with ``composite: true``, over shard list files)."""
    yaml = pytest.importorskip("yaml")
    caps = [[f"video{v}", json.dumps([{"caption": f"clip {v} take {k}"}
                                      for k in range(2)])] for v in range(8)]
    jtsv.tsv_writer(caps, str(tmp_path / "cap.tsv"))
    with open(tmp_path / "cap.linelist.tsv", "w") as f:
        f.writelines(f"{v}\t{k}\n" for v in range(8) for k in range(2))
    with open(tmp_path / "list.txt", "w") as f:
        f.write(f"{TSV}\n{tmp_path / 'cap.tsv'}\n")
    with open(tmp_path / "shards.tsv", "w") as f:
        f.writelines(f"0\t{v}\t{v % 2}\n" for v in range(8))
    docs = {"plain.yaml": {"img": TSV, "caption": str(tmp_path / "cap.tsv"),
                           "caption_linelist": "cap.linelist.tsv"},
            "shards.yaml": {"composite": True, "img": "list.txt",
                            "caption_linelist": "shards.tsv"}}
    jt, tt = tokenizers
    for name, doc in docs.items():
        with open(tmp_path / name, "w") as f:
            yaml.safe_dump(doc, f)
        for split in ("train", "val"):
            jc, tc = _cfgs(img_transform=("img_rand_crop",))
            jd = jcomp.CompositeCaptionDataset(jc, jt, str(tmp_path / name),
                                               split)
            td = tcomp.CompositeCaptionDataset(tc, tt, str(tmp_path / name),
                                               split)
            assert td.image_keys == jd.image_keys
            assert td.get_composite_source_idx() == \
                jd.get_composite_source_idx()
            _compare_items(jd, td, n=3)
            if name == "plain.yaml":
                assert td.get_captions_by_key("video3") == \
                    jd.get_captions_by_key("video3")


def test_load_task_data(tokenizers, monkeypatch):
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    jt, tt = tokenizers
    jc, tc = _cfgs()
    jsets = jds.load_task_data(jc, jret.RetrievalDataset, jt)
    tsets = tds.load_task_data(tc, tret.RetrievalDataset, tt)
    assert tsets.keys() == jsets.keys() == {"train", "val"}
    for k in jsets:
        assert tsets[k].txt == jsets[k].txt
        assert tsets[k].id2lineidx == jsets[k].id2lineidx


def test_decode_path_is_logged(tokenizers, rows, monkeypatch, caplog):
    monkeypatch.setenv("LAVENDER_NATIVE", "0")
    _, txt = rows
    with caplog.at_level("INFO", logger="lavender_tpu_torch.data.dataset"):
        _pairs(tokenizers, rows, jret.RetrievalDataset,
               tret.RetrievalDataset, "val", txt["val"], _cfgs())
    assert "LAVENDER_NATIVE=0" in caplog.text
    assert f"python:{ttf.decoder()}" in caplog.text
    monkeypatch.setenv("LAVENDER_NATIVE", "1")
    assert tds.decode_path(_cfgs(img_transform=("pad_resize",))[1])[0] == \
        "python"
    monkeypatch.setattr(native, "unavailable", lambda: "no header")
    assert tds.decode_path(_cfgs()[1]) == \
        ("python", "native library not built: no header")


# ---- samplers, loaders ----

def test_samplers():
    for n in (1, 7, 16):
        for shuffle in (False, True):
            for world in (1, 3):
                for rank in range(world):
                    j = jloader.ShardedSampler(n, shuffle, 5, rank, world)
                    t = tloader.ShardedSampler(n, shuffle, 5, rank, world)
                    for ep in (0, 2):
                        j.set_epoch(ep), t.set_epoch(ep)
                        assert t.indices() == j.indices()
                    j = jloader.LimitedSampler(n, shuffle, 3, 5, rank, world)
                    t = tloader.LimitedSampler(n, shuffle, 3, 5, rank, world)
                    assert t.indices() == j.indices()
                    src = [i % 4 for i in range(n)]
                    j = jloader.NodeSplitSampler(src, shuffle, 5, rank, world)
                    t = tloader.NodeSplitSampler(src, shuffle, 5, rank, world)
                    assert t.indices() == j.indices()


@pytest.fixture(scope="module")
def train_sets(tokenizers, rows):
    _, txt = rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LAVENDER_NATIVE", "0")
        return _pairs(tokenizers, rows, jret.RetrievalDataset,
                      tret.RetrievalDataset, "train", txt["train"],
                      _cfgs(img_transform=("img_rand_crop", "vid_rand_crop")))


def test_loader_batches_and_prefetch(train_sets):
    jd, td = train_sets
    for kw in ({"shuffle": True}, {"shuffle": False, "drop_last": True}):
        jdl = jloader.DataLoader(jd, 5, num_workers=1, **kw)
        tdl = tloader.DataLoader(td, 5, num_workers=1, **kw)
        assert len(tdl) == len(jdl)
        jd.rng.seed(3), td.rng.seed(3)
        want = list(jloader.IterationBasedBatchIter(jdl, 4))
        got = list(tloader.IterationBasedBatchIter(tdl, 4))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
        # the prefetch on the CPU: the same batches, as tensors
        jd.rng.seed(3), td.rng.seed(3)
        want = list(jdl)
        got = list(tloader.device_prefetch(tdl, "cpu"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert all(isinstance(v, torch.Tensor) for v in a.values())
            _assert_items_equal(a, b)
    items = [td[i] for i in range(3)]
    _assert_items_equal(tloader.default_collate(items),
                        jloader.default_collate(items))


def test_meta_loader_task_sequence():
    loaders = {"a": [{"x": np.zeros(1)}] * 3, "b": [{"x": np.ones(1)}] * 2,
               "c": [{"x": np.full(1, 2.0)}]}
    ratios = {"a": 3, "b": 1, "c": 2}
    for accum in (1, 3):
        j = iter(jloader.MetaLoader(loaders, ratios, accum, seed=4))
        t = iter(tloader.MetaLoader(loaders, ratios, accum, seed=4))
        for _ in range(20):
            (jn, jb), (tn, tb) = next(j), next(t)
            assert tn == jn
            _assert_items_equal(tb, jb)
