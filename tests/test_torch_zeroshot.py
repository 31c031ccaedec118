"""The port's zero-shot text side against the JAX package's on the CPU: the
tokenizer (hash vocabulary bit for bit; a ``tokenizer.json`` through
transformers), every vendored prompt bank, the presets' vendored fallback,
the text tower and ``encode_text`` at a narrow width (from flax params and
from release-layout keys, pad-heavy rows included), the classifier weights
built from both packages' towers and the caches each package writes."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu import config as jconfig
from moc_tpu.zeroshot import classifier as jclassifier
from moc_tpu.zeroshot import coca as jcoca
from moc_tpu.zeroshot import convert as jconvert
from moc_tpu.zeroshot import prompts as jprompts
from moc_tpu.zeroshot import text_tower as jtext
from moc_tpu.zeroshot import tokenizer as jtokenizer
from moc_tpu.zeroshot import vision_tower as jvision
from moc_tpu_torch import config
from moc_tpu_torch.convert import coca_from_jax, text_tower_from_jax
from moc_tpu_torch.zeroshot import classifier, coca, convert, prompts, tokenizer
from moc_tpu_torch.zeroshot.text_tower import TextConfig, TextTower, text_attention_mask
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

RTOL, ATOL = 2e-4, 2e-5  # the JAX package's conversion tolerance
SMALL_TEXT = dict(context_length=16, vocab_size=211, width=32, heads=4, layers=2, output_dim=24)
# a checkpoint the loader can read (heads = width / 64), with the CONCH
# vocabulary so that hash ids fit, and a 2-layer text tower
RELEASE_TEXT = dict(context_length=128, vocab_size=32007, width=128, heads=2, layers=2,
                    output_dim=64)
RELEASE_VISION = dict(image_size=32, patch_size=16, width=64, layers=1, heads=1,
                      embed_dim_contrast=32, embed_dim_caption=64, n_queries_caption=4)
PROMPTS = sorted(f for f in os.listdir(config.DEFAULT_PROMPT_ROOT) if f.endswith(".json"))

TEXTS = {
    "ascii": ["a photomicrograph showing lung adenocarcinoma.", "tumor", "  spaced   out  "],
    "unicode": ["Ünïcödé tümor — naïve café", "腫瘍 の 画像", "emoji 🔬 slide"],
    "empty": ["", "   ", "\t\n"],
    "over_long": [" ".join(f"w{i}" for i in range(200)), "x " * 124 + "y z", "a " * 125],
}


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_hash_tokenizer_ids_bit_equal(case):
    want = jtokenizer.ConchTokenizer()(TEXTS[case])
    got = tokenizer.ConchTokenizer()(TEXTS[case])
    assert got.dtype == want.dtype == np.int32 and got.shape == (3, 128)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == 0).all() and (got[:, 0] == 1).all()


def _tokenizer_json(path):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    words = ["a", "photomicrograph", "showing", "lung", "adenocarcinoma", "tumor"]
    vocab = {"<pad>": 0, "<start_of_text>": 1, "[UNK]": 2,
             **{w: i + 3 for i, w in enumerate(words)}, "<end_of_text>": len(words) + 3}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.post_processor = processors.TemplateProcessing(
        single="<start_of_text> $A <end_of_text>",
        special_tokens=[("<start_of_text>", 1), ("<end_of_text>", len(words) + 3)])
    tk.save(str(path))
    return str(path)


def test_tokenizer_file_through_transformers(tmp_path, monkeypatch):
    path = _tokenizer_json(tmp_path / "tokenizer.json")
    texts = ["a photomicrograph showing lung adenocarcinoma .", "tumor " * 200]
    got = tokenizer.ConchTokenizer(path)(texts)
    np.testing.assert_array_equal(got, jtokenizer.ConchTokenizer(path)(texts))
    assert got.shape == (2, 128) and got[0, 0] == 1 and got[1, 126] == 9
    monkeypatch.setitem(sys.modules, "transformers", None)  # a host without transformers
    with pytest.raises(ImportError, match="transformers"):
        tokenizer.ConchTokenizer(path)


@pytest.mark.parametrize("name", PROMPTS)
def test_vendored_prompt_banks_load_alike(name):
    port = os.path.join(config.DEFAULT_PROMPT_ROOT, name)
    with open(port) as f:
        labels = {lab: i for i, lab in enumerate(json.load(f)["0"]["classnames"])}
    want = jprompts.load_prompt_bank(os.path.join(jconfig.DEFAULT_PROMPT_ROOT, name), labels)
    got = prompts.load_prompt_bank(port, labels)
    assert (got.classnames, got.templates, got.labels) == \
        (want.classnames, want.templates, want.labels)
    assert [got.texts_for_class(c) for c in range(got.n_classes)] == \
        [want.texts_for_class(c) for c in range(want.n_classes)]


def test_prompt_bank_round_trip_across_packages(tmp_path):
    bank = prompts.make_prompt_bank({"LUAD": ["lung adenocarcinoma", "LUAD"], "LUSC": ["lusc"]},
                                    ["CLASSNAME.", "an image of CLASSNAME."],
                                    {"LUSC": 1, "LUAD": 0})
    assert bank.labels == ("LUAD", "LUSC")
    assert bank.texts_for_class(0)[1] == ["LUAD.", "an image of LUAD."]
    prompts.save_prompt_bank(str(tmp_path / "b.json"), bank)
    back = jprompts.load_prompt_bank(str(tmp_path / "b.json"), {"LUAD": 0, "LUSC": 1})
    assert (back.classnames, back.templates, back.labels) == \
        (bank.classnames, bank.templates, bank.labels)


def test_presets_match_jax_and_fall_back_to_the_vendored_files(tmp_path):
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    for name, preset in config.PRESETS.items():
        jp = jconfig.PRESETS[name]
        for field in ("label_dict", "label_dict_ext", "n_classes", "csv_name", "feature_dir",
                      "splits_subdir", "prompt_file", "prompt_file_ext"):
            assert getattr(preset, field) == getattr(jp, field), (name, field)
        for f, labels in ((preset.prompt_file, preset.label_dict),
                          (preset.prompt_file_ext, preset.label_dict_ext)):
            bank = prompts.load_prompt_bank(os.path.join(config.DEFAULT_PROMPT_ROOT, f), labels)
            assert bank.n_classes == len(set(labels.values()))
    nsclc, root = config.NSCLC, str(tmp_path / "data")
    assert nsclc.csv_path(root) == os.path.join(config.ASSETS_DIR, "dataset_csv", "nsclc.csv")
    assert nsclc.split_csv(root, 8, 2) == os.path.join(
        config.ASSETS_DIR, "splits", "nsclc_fewshot", "8shots", "splits_2.csv")
    # the port's own copies, byte for byte the JAX package's
    for path in (nsclc.csv_path(root), nsclc.split_csv(root, 8, 2)):
        twin = os.path.join(jconfig.ASSETS_DIR, os.path.relpath(path, config.ASSETS_DIR))
        with open(path, "rb") as a, open(twin, "rb") as b:
            assert a.read() == b.read()
    # copies under --data_root win
    own_csv = os.path.join(root, "dataset_csv", "nsclc.csv")
    own_split = os.path.join(root, "splits", "nsclc_fewshot", "8shots", "splits_2.csv")
    for path in (own_csv, own_split):
        os.makedirs(os.path.dirname(path))
        open(path, "w").close()
    assert (nsclc.csv_path(root), nsclc.split_csv(root, 8, 2)) == (own_csv, own_split)
    # absent everywhere: the user's path, so the error names it
    assert nsclc.split_csv(root, 3, 0) == os.path.join(root, "splits", "nsclc_fewshot",
                                                       "3shots", "splits_0.csv")


def _pad_heavy_ids(rng, rows, seq, vocab):
    """Rows of 0, 1, a few and ``seq`` real ids, trailing pads (id 0)."""
    ids = np.zeros((rows, seq), np.int32)
    for i, n in enumerate([0, 1, 3, seq, *rng.integers(2, seq, size=rows - 4)]):
        ids[i, :n] = rng.integers(1, vocab, size=n)
    return ids


@pytest.fixture(scope="module")
def small_text():
    """A flax-initialised narrow JAX text tower, its params as numpy, and
    pad-heavy ids."""
    model = jtext.TextTower(jtext.TextConfig(**SMALL_TEXT))
    ids = _pad_heavy_ids(np.random.default_rng(0), 7, 15, 211)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3), jnp.asarray(ids)))
    return model, params, ids


def test_text_tower_from_flax_params_matches_jax(small_text):
    model, params, ids = small_text
    tower = text_tower_from_jax(params, TextConfig(**SMALL_TEXT)).eval()
    assert tower.cfg == TextConfig(**SMALL_TEXT)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(model.apply(params, ids)), rtol=RTOL, atol=ATOL)


def test_text_mask_quirks():
    """The CLS row only carries the pad window, shifted right by one column;
    every other row is causal; no row is all −inf."""
    ids = torch.tensor([[5, 7, 0, 0], [0, 0, 0, 0], [3, 0, 4, 0]])
    mask = text_attention_mask(ids, 0)[:, 0]
    assert mask.shape == (3, 5, 5)
    causal = torch.full((5, 5), float("-inf")).triu(1)
    assert torch.equal(mask[:, :4], causal[:4].expand(3, 4, 5))
    open_cols = mask[:, 4] == 0
    assert open_cols.tolist() == [[True, True, True, False, False],
                                  [True, False, False, False, False],
                                  [True, True, False, True, False]]
    assert torch.isfinite(mask).any(-1).all()


def test_release_keys_match_jax_converter(tmp_path):
    """Release-layout text keys → the port (``convert_text_tower``, and the
    whole CoCa through ``load_conch``) and → flax through the JAX converter
    give the same tower on pad-heavy ids; ``encode_text`` and ``forward``
    match JAX's ``CoCa``."""
    sd = convert.random_conch_state_dict(VisionConfig(**RELEASE_VISION), seed=5,
                                         text=TextConfig(**RELEASE_TEXT))
    assert "text_decoder.ln_final.weight" in sd
    path = str(tmp_path / "conch.bin")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    model = convert.load_conch(path, image_size=32, device="cpu")
    assert model.cfg.text == TextConfig(**RELEASE_TEXT) and not model.training
    small = TextTower(TextConfig(**RELEASE_TEXT))
    small.load_state_dict(convert.convert_text_tower(sd))
    jparams = jconvert.convert_conch_checkpoint(sd, image_size=32)
    jmodel = jcoca.CoCa(jcoca.CoCaConfig(text=jtext.TextConfig(**RELEASE_TEXT),
                                         vision=jvision.VisionConfig(**RELEASE_VISION)))
    rng = np.random.default_rng(1)
    ids = np.concatenate([_pad_heavy_ids(rng, 6, 127, 32007), np.zeros((6, 1), np.int32)], 1)
    want = np.asarray(jmodel.apply(jparams, ids, method=jmodel.encode_text))
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jimg, jtxt, jscale = jmodel.apply(jparams, imgs, ids[:2])
    with torch.no_grad():
        np.testing.assert_allclose(model.encode_text(torch.from_numpy(ids)).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(small(torch.from_numpy(ids[:, :-1])).numpy(),
                                   np.asarray(jmodel.apply(jparams, ids, normalize=False,
                                                           method=jmodel.encode_text)),
                                   rtol=RTOL, atol=ATOL)
        img, txt, scale = model(torch.from_numpy(imgs), torch.from_numpy(ids[:2]))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jtxt), rtol=RTOL, atol=ATOL)
    assert float(scale) == pytest.approx(float(jscale), rel=1e-6)
    np.testing.assert_allclose(np.linalg.norm(txt.numpy(), axis=1), 1.0, rtol=1e-5)
    # the flax route carries the same weights into the same module
    same = coca_from_jax(jax.tree.map(np.asarray, jparams),
                         coca.CoCaConfig(text=TextConfig(**RELEASE_TEXT),
                                         vision=VisionConfig(**RELEASE_VISION)))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), same.state_dict()[k].numpy(), err_msg=k)


def test_random_checkpoint_refuses_inexpressible_heads():
    with pytest.raises(ValueError, match="head counts"):
        convert.random_conch_state_dict(VisionConfig(**RELEASE_VISION),
                                        text=TextConfig(**SMALL_TEXT))


@pytest.fixture(scope="module")
def release_pair(tmp_path_factory):
    """A narrow release checkpoint on disk, the port's CoCa loaded from it
    and JAX's encode_text over the same weights."""
    root = tmp_path_factory.mktemp("release")
    sd = convert.random_conch_state_dict(VisionConfig(**RELEASE_VISION), seed=2,
                                         text=TextConfig(**RELEASE_TEXT))
    torch.save(sd, root / "conch.bin")
    jmodel = jcoca.CoCa(jcoca.CoCaConfig(text=jtext.TextConfig(**RELEASE_TEXT),
                                         vision=jvision.VisionConfig(**RELEASE_VISION)))
    jencode = jclassifier.make_encode_text_fn(
        jmodel, jconvert.convert_conch_checkpoint(sd, image_size=32))
    model = convert.load_conch(str(root / "conch.bin"), image_size=32, device="cpu")
    return str(root / "conch.bin"), model, jencode


def test_classifier_weights_match_jax(release_pair):
    _, model, jencode = release_pair
    preset = config.NSCLC
    bank = prompts.load_prompt_bank(
        os.path.join(config.DEFAULT_PROMPT_ROOT, preset.prompt_file_ext), preset.label_dict_ext)
    jbank = jprompts.load_prompt_bank(
        os.path.join(jconfig.DEFAULT_PROMPT_ROOT, preset.prompt_file_ext), preset.label_dict_ext)
    encode = classifier.make_encode_text_fn(model, "cpu")
    w = classifier.build_zero_shot_classifier(encode, tokenizer.ConchTokenizer(), bank)
    want = jclassifier.build_zero_shot_classifier(jencode, jtokenizer.ConchTokenizer(), jbank)
    assert w.shape == want.shape == (64, 6) and w.dtype == np.float32
    np.testing.assert_allclose(w, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(w, axis=0), 1.0, rtol=1e-6)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_classifier_weights_bit_equal_on_identical_embeddings():
    """Fed the same embeddings, both builders give the same bits."""
    def encode(ids):
        out = []
        for row in np.asarray(ids):
            v = np.random.default_rng(int(row.sum()) % 2 ** 31).normal(size=48)
            out.append(v / np.linalg.norm(v))
        return np.stack(out).astype(np.float32)

    bank = prompts.make_prompt_bank({"A": ["alpha", "ay", "a"], "B": ["beta"], "C": ["c", "cc"]},
                                    [f"t{i} CLASSNAME" for i in range(7)], {"A": 0, "B": 1, "C": 2})
    jbank = jprompts.make_prompt_bank({"A": ["alpha", "ay", "a"], "B": ["beta"],
                                       "C": ["c", "cc"]},
                                      [f"t{i} CLASSNAME" for i in range(7)],
                                      {"A": 0, "B": 1, "C": 2})
    got = classifier.build_zero_shot_classifier(encode, tokenizer.ConchTokenizer(), bank)
    want = jclassifier.build_zero_shot_classifier(lambda i: jnp.asarray(encode(i)),
                                                  jtokenizer.ConchTokenizer(), jbank)
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_weight_caches_read_across_packages(tmp_path, writer):
    bank = prompts.make_prompt_bank({"A": ["a"], "B": ["b"]}, ["CLASSNAME"], {"A": 0, "B": 1})
    jbank = jprompts.make_prompt_bank({"A": ["a"], "B": ["b"]}, ["CLASSNAME"], {"A": 0, "B": 1})
    calls = []

    def encode(ids):
        calls.append(len(ids))
        v = np.asarray(ids, np.float32)[:, :8] + 1
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    path = str(tmp_path / "cache" / "weights_x_conch.npz")
    make = (classifier.cached_zero_shot_classifier if writer == "port"
            else jclassifier.cached_zero_shot_classifier)
    read = (jclassifier.cached_zero_shot_classifier if writer == "port"
            else classifier.cached_zero_shot_classifier)
    w = make(path, encode, tokenizer.ConchTokenizer(), bank if writer == "port" else jbank)
    assert calls == [1, 1]
    back = read(path, encode, tokenizer.ConchTokenizer(), jbank if writer == "port" else bank)
    assert calls == [1, 1] and np.asarray(back).tobytes() == np.asarray(w).tobytes()
    rebuilt = classifier.cached_zero_shot_classifier(path, encode, tokenizer.ConchTokenizer(),
                                                     bank, use_cache=False)
    assert calls == [1, 1, 1, 1] and rebuilt.tobytes() == np.asarray(w).tobytes()
