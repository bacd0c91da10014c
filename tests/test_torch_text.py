"""Text input of the port held against ``avenir_tpu`` on the CPU: the
tokenizer and Porter stemmer (the classic vectors of ``tests/test_text.py``
and a seeded vocabulary), ``WordCount`` (its ``bincount`` on the counter's
device), the WordCounter job and NB's text path (``tabular.input=false``:
train, predict, validate) through both CLIs — part files and counters
byte-identical."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from avenir_tpu.__main__ import main as jax_main  # noqa: E402
from avenir_tpu.text import WordCount as JWordCount  # noqa: E402
from avenir_tpu.text import porter_stem as j_stem  # noqa: E402
from avenir_tpu.text import tokenize as j_tokenize  # noqa: E402
from avenir_tpu_torch.__main__ import main as torch_main  # noqa: E402
from avenir_tpu_torch.text import STOPWORDS, WordCount, porter_stem, tokenize  # noqa: E402

# Porter (1980)'s examples, as tests/test_text.py holds the JAX package's
VECTORS = {
    "caresses": "caress", "ponies": "poni", "caress": "caress",
    "cats": "cat", "feed": "feed", "agreed": "agre",
    "plastered": "plaster", "motoring": "motor", "sing": "sing",
    "conflated": "conflat", "troubled": "troubl", "sized": "size",
    "hopping": "hop", "tanned": "tan", "falling": "fall",
    "hissing": "hiss", "fizzed": "fizz", "failing": "fail",
    "filing": "file", "happy": "happi", "sky": "sky",
    "relational": "relat", "conditional": "condit", "rational": "ration",
    "valenci": "valenc", "hesitanci": "hesit", "digitizer": "digit",
    "conformabli": "conform", "radicalli": "radic", "differentli": "differ",
    "vileli": "vile", "analogousli": "analog", "vietnamization": "vietnam",
    "predication": "predic", "operator": "oper", "feudalism": "feudal",
    "decisiveness": "decis", "hopefulness": "hope", "callousness": "callous",
    "formaliti": "formal", "sensitiviti": "sensit", "sensibiliti": "sensibl",
    "triplicate": "triplic", "formative": "form", "formalize": "formal",
    "electriciti": "electr", "electrical": "electr", "hopeful": "hope",
    "goodness": "good", "revival": "reviv", "allowance": "allow",
    "inference": "infer", "airliner": "airlin", "gyroscopic": "gyroscop",
    "adjustable": "adjust", "defensible": "defens", "irritant": "irrit",
    "replacement": "replac", "adjustment": "adjust", "dependent": "depend",
    "adoption": "adopt", "homologou": "homolog", "communism": "commun",
    "activate": "activ", "angulariti": "angular", "homologous": "homolog",
    "effective": "effect", "bowdlerize": "bowdler",
    "probate": "probat", "rate": "rate", "cease": "ceas",
    "controll": "control", "roll": "roll",
}
SUFFIXES = ["", "s", "es", "ed", "ing", "ation", "ness", "ful", "ly", "er",
            "ement", "ize", "ous", "ive", "al"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _vocab(n, seed):
    """n distinct-ish words: consonant-vowel stems with English suffixes."""
    rng = np.random.default_rng(seed)
    cons, vow = list("bcdfghklmnprstvwyz"), list("aeiouy")
    words = []
    for _ in range(n):
        stem = "".join(rng.choice(cons) + rng.choice(vow)
                       for _ in range(rng.integers(1, 4)))
        words.append(stem + SUFFIXES[rng.integers(len(SUFFIXES))])
    return words + sorted(STOPWORDS)


def _corpus(n_lines, seed, classes=("pos", "neg")):
    """``text,class`` lines: 8 Zipf-drawn words each, the class shifting
    which half of the vocabulary is likelier; some apostrophes, capitals,
    digits and punctuation for the tokenizer."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(300, seed)
    ranks = np.minimum(rng.zipf(1.3, (n_lines, 8)), len(vocab)) - 1
    cls = rng.integers(0, len(classes), n_lines)
    lines = []
    for i in range(n_lines):
        words = [vocab[(r + 37 * cls[i]) % len(vocab)] for r in ranks[i]]
        if i % 7 == 0:
            words[0] = words[0].capitalize() + "'s"
        if i % 11 == 0:
            words.append(f"x{i % 5}!")
        lines.append(f"{' '.join(words)},{classes[cls[i]]}")
    return lines


def test_tokenize_and_stem_equal_jax():
    for word, want in VECTORS.items():
        assert porter_stem(word) == want == j_stem(word)
    for w in _vocab(3000, 1):
        assert porter_stem(w) == j_stem(w)
    for text in _corpus(300, 2) + ["The quick brown Fox, jumped over THE lazy dog!",
                                  "to be or not", "", "''' don't 42 a-b"]:
        for stop in (True, False):
            for stem in (True, False):
                assert (tokenize(text, stopwords=stop, stem=stem)
                        == j_tokenize(text, stopwords=stop, stem=stem))


@pytest.mark.parametrize("stem", [False, True])
def test_wordcount_equals_jax(stem):
    lines = [ln.split(",")[0] for ln in _corpus(2000, 3)]
    wc, jwc = WordCount(stem=stem, device="cpu"), JWordCount(stem=stem)
    for lo in range(0, 2000, 700):             # a growing vocabulary
        wc.add_lines(lines[lo:lo + 700])
        jwc.add_lines(lines[lo:lo + 700])
    assert wc.vocab == jwc.vocab
    assert wc.counts.dtype == np.int64
    assert wc.items() == jwc.items()
    assert wc.top(15) == jwc.top(15)
    assert wc.to_lines(";") == jwc.to_lines(";")
    assert wc.to_lines(sort=False) == jwc.to_lines(sort=False)
    wc.add_lines([])
    assert wc.items() == jwc.items()


def test_wordcount_needs_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WordCount()


@pytest.mark.parametrize("props", [
    [],
    ["-Dremove.stop.words=false"],
    ["-Dstem.words=true"],
    ["-Dtext.field.ordinal=0"],
    ["-Dtext.field.ordinal=1"],
])
def test_word_counter_byte_identical(tmp_path, props):
    (tmp_path / "in").mkdir()
    corpus = _corpus(1500, 4)
    (tmp_path / "in" / "part-a").write_text("\n".join(corpus[:900]) + "\n\n")
    (tmp_path / "in" / "part-b").write_text("\n".join(corpus[900:]) + "\n")
    outs = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        text = _run(main, ["org.avenir.text.WordCounter", *props,
                           str(tmp_path / "in"), str(tmp_path / pkg), *extra])
        outs[pkg] = ((tmp_path / pkg / "part-00000").read_bytes(), text)
    assert outs["torch"] == outs["jax"]
    assert "Processed=1500" in outs["torch"][1]


@pytest.mark.parametrize("props", [
    [],
    ["-Dstem.words=true", "-Dremove.stop.words=false"],
    ["-Dlaplace.smoothing=0.5", "-Dpositive.class.value=neg"],
])
def test_nb_text_train_predict_validate_byte_identical(tmp_path, props):
    """BayesianDistribution and BayesianPredictor (prediction and
    validation) with ``tabular.input=false``; the validation input holds a
    class the model never saw (``Validation::UnknownActualClass``)."""
    train = _corpus(3000, 5, classes=("pos", "neg", "mid"))
    test = _corpus(600, 6, classes=("pos", "neg", "mid", "odd"))
    (tmp_path / "train.txt").write_text("\n".join(train) + "\n")
    (tmp_path / "test.txt").write_text("\n".join(test) + "\n")
    outs = {}
    for pkg, main, extra in (("jax", jax_main, []),
                             ("torch", torch_main, ["--device", "cpu"])):
        common = ["-Dtabular.input=false", *props]
        model = tmp_path / f"{pkg}_model"
        texts = [_run(main, ["BayesianDistribution", *common,
                             str(tmp_path / "train.txt"), str(model), *extra])]
        files = [(model / "part-00000").read_bytes()]
        for mode in ("prediction", "validation"):
            out = tmp_path / f"{pkg}_{mode}"
            texts.append(_run(main, [
                "org.avenir.bayesian.BayesianPredictor", *common,
                f"-Dbayesian.model.file.path={model}",
                f"-Dprediction.mode={mode}", str(tmp_path / "test.txt"),
                str(out), *extra]))
            files.append((out / "part-00000").read_bytes())
        outs[pkg] = (files, texts)
    assert outs["torch"] == outs["jax"]
    assert "UnknownActualClass=" in outs["torch"][1][2]
    assert "Vocabulary=" in outs["torch"][1][0]
