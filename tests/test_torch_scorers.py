"""The port's scorers and evaluator against the JAX package's copies: equal
floats, not close ones, since the arithmetic is the same line for line.

Inputs: caption dicts drawn by hypothesis (words, punctuation, contractions,
non-ASCII, empty strings) and the repository's real-text submissions,
``quality_sub_ref.json`` as the ground truth (its timestamps and sentences
per video) against ``quality_sub_ours.json`` as the prediction, 128 videos.
The JAX evaluator draws its garbage references from the global ``random``
after ``random.seed(s)``; the port's from ``random.Random(s)``."""

from __future__ import annotations

import json
import os
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodal_feature_learning_tpu.evaluation import anet_eval as jeval
from multimodal_feature_learning_tpu.evaluation import tokenizer as jtok
from multimodal_feature_learning_tpu.evaluation.metrics import meteor as jmeteor
from multimodal_feature_learning_tpu.evaluation.metrics import (
    Bleu as JBleu, Cider as JCider, Meteor as JMeteor, Rouge as JRouge)
from multimodal_feature_learning_tpu.utils import postprocess as jpost
from multimodal_feature_learning_tpu_torch.evaluation import anet_eval as teval
from multimodal_feature_learning_tpu_torch.evaluation import tokenizer as ttok
from multimodal_feature_learning_tpu_torch.evaluation.metrics import meteor as tmeteor
from multimodal_feature_learning_tpu_torch.evaluation.metrics import (
    Bleu as TBleu, Cider as TCider, Meteor as TMeteor, Rouge as TRouge)
from multimodal_feature_learning_tpu_torch.utils import postprocess as tpost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIOUS = [0.3, 0.5, 0.7, 0.9]

WORDS = ["a", "man", "men", "is", "are", "playing", "plays", "played", "guitar", "guitars",
         "the", "dog", "dogs", "runs", "running", "across", "field", "person", "rides",
         "riding", "bike", "crowd", "cheers", "happily", "generalization", "relational"]
TOKENS = WORDS + [",", ".", "!", "?", "n't", "'s", "-", "--", "(", ")", "café", "-LRB-"]

sentence = st.lists(st.sampled_from(TOKENS), min_size=0, max_size=12).map(" ".join)
caption_dicts = st.dictionaries(
    st.integers(0, 40), st.tuples(sentence, st.lists(sentence, min_size=1, max_size=4)),
    min_size=1, max_size=8)
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


class EvalCfg:
    tious = TIOUS
    max_proposals_per_video = 100
    verbose = False


def tokenized(pairs):
    """{k: (hyp, refs)} -> PTB-tokenized (gts, res) as the evaluator feeds
    its scorers."""
    tok = jtok.PTBTokenizer()
    res = tok.tokenize({k: [{"caption": h}] for k, (h, _) in pairs.items()})
    gts = tok.tokenize({k: [{"caption": r} for r in refs] for k, (_, refs) in pairs.items()})
    return gts, res


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(synonym file, paraphrase file), written here."""
    d = tmp_path_factory.mktemp("meteor")
    syn = d / "synsets.txt"
    syn.write_text("man person guy\ndog hound\nbike bicycle cycle\nrides pedals\n"
                   "crowd audience\nsolo\n")
    para = d / "paraphrase.txt"
    para.write_text("0.5 ||| plays the guitar ||| strums\nruns across ||| crosses\n"
                    "a crowd ||| people\nthe field ||| the field\nbad line\n")
    return str(syn), str(para)


def scorer_pairs(name, tables):
    syn, para = tables
    return {
        "bleu": (JBleu(4), TBleu(4)),
        "rouge": (JRouge(), TRouge()),
        "cider": (JCider(), TCider()),
        "meteor": (JMeteor(), TMeteor()),
        "meteor_synonyms": (JMeteor(synonym_file=syn), TMeteor(synonym_file=syn)),
        "meteor_paraphrases": (JMeteor(paraphrase_file=para), TMeteor(paraphrase_file=para)),
        "meteor2005": (jmeteor.Meteor2005(), tmeteor.Meteor2005()),
    }[name]


@given(line=st.text(max_size=60) | sentence)
@settings(max_examples=80, deadline=None)
def test_tokenizer_equals_jax(line):
    assert ttok.ptb_tokenize_line(line) == jtok.ptb_tokenize_line(line)
    caps = {0: [{"caption": line}], 1: [{"caption": line.upper()}, {"caption": ""}]}
    assert ttok.PTBTokenizer().tokenize(caps) == jtok.PTBTokenizer().tokenize(caps)
    assert ttok.PUNCTUATIONS == jtok.PUNCTUATIONS


@pytest.mark.parametrize("name", ["bleu", "rouge", "cider", "meteor", "meteor_synonyms",
                                  "meteor_paraphrases", "meteor2005"])
@given(pairs=caption_dicts)
@SETTINGS
def test_scorer_equals_jax(tables, name, pairs):
    gts, res = tokenized(pairs)
    ref_scorer, got_scorer = scorer_pairs(name, tables)
    assert got_scorer.method() == ref_scorer.method()
    assert got_scorer.compute_score(gts, res) == ref_scorer.compute_score(gts, res)


@given(word=st.text(alphabet="abcdefghijklmnopqrstuvwxyz", max_size=14) | st.sampled_from(WORDS))
@settings(max_examples=200, deadline=None)
def test_porter_stem_equals_jax(word):
    assert tmeteor.porter_stem(word) == jmeteor.porter_stem(word)


@pytest.mark.parametrize("kind", ["synonyms", "paraphrases"])
def test_meteor_tables_from_the_environment_equal_jax(tables, monkeypatch, kind):
    syn, para = tables
    var, path = (("MFL_METEOR_SYNONYMS", syn) if kind == "synonyms"
                 else ("MFL_METEOR_PARAPHRASES", para))
    monkeypatch.setenv(var, path)
    ref, got = JMeteor(), TMeteor()
    attr = "synsets" if kind == "synonyms" else "paraphrases"
    assert getattr(got, attr) == getattr(ref, attr) and getattr(got, attr)
    gts = {0: ["a guy pedals a bicycle across the field"], 1: ["people cheers"]}
    res = {0: ["a man rides a bike across the field"], 1: ["a crowd cheers"]}
    assert got.compute_score(gts, res) == ref.compute_score(gts, res)
    plain = TMeteor(synsets={}, paraphrases={}).compute_score(gts, res)[0]
    assert got.compute_score(gts, res)[0] > plain  # the table was used
    monkeypatch.setenv(var, path + ".missing")
    with pytest.warns(UserWarning):
        assert getattr(TMeteor(), attr) is None
    with pytest.raises(FileNotFoundError):
        TMeteor(**{("synonym_file" if kind == "synonyms" else "paraphrase_file"):
                   path + ".missing"})


@pytest.fixture(scope="module")
def quality():
    """(ground truth dict, prediction submission) of the real-text files."""
    with open(os.path.join(ROOT, "quality_sub_ref.json")) as f:
        ref = json.load(f)
    with open(os.path.join(ROOT, "quality_sub_ours.json")) as f:
        ours = json.load(f)
    gt = {k: {"timestamps": [e["timestamp"] for e in v],
              "sentences": [e["sentence"] for e in v]} for k, v in ref["results"].items()}
    assert len(gt) == len(ours["results"]) == 128
    return gt, ours


def jax_run_eval(seed, *args):
    state = random.getstate()
    random.seed(seed)
    try:
        return jeval.run_eval(*args)
    finally:
        random.setstate(state)


@pytest.fixture(scope="module")
def quality_scores(quality):
    gt, ours = quality
    return (jax_run_eval(5, EvalCfg, ours, gt),
            teval.run_eval(EvalCfg, ours, gt, rng=random.Random(5)))


def test_evaluator_equals_jax_on_real_text(quality_scores):
    ref, got = quality_scores
    assert got == ref
    assert set(got) >= {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision",
                        "Recall-0.5"}
    assert all(len(got[m]) == len(TIOUS) for m in ("Bleu_1", "METEOR", "CIDEr", "Recall"))
    assert 0 < got["METEOR"][1] < 1 and got["CIDEr"][0] > 0


def test_pprint_eval_scores_equals_jax(quality_scores):
    ref, got = quality_scores
    assert tpost.pprint_eval_scores(got) == jpost.pprint_eval_scores(ref)
    assert tpost.pprint_eval_scores({"Precision": [0.0], "Recall": [0.0]}) == \
        jpost.pprint_eval_scores({"Precision": [0.0], "Recall": [0.0]})


def test_run_eval_reads_gt_files_equal_to_jax(quality, tmp_path):
    """GT from two files; some predictions shifted so that they match no
    event and are scored against garbage from the random stream."""
    gt, ours = quality
    keys = sorted(gt)[:24]
    halves = [{k: gt[k] for k in keys[:12]}, {k: gt[k] for k in keys[12:]}]
    paths = []
    for i, half in enumerate(halves):
        paths.append(str(tmp_path / f"gt{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(half, f)
    sub = jpost.get_sample_submission()
    assert tpost.get_sample_submission() == sub
    for i, k in enumerate(keys + ["v_not_in_gt"]):
        preds = ours["results"].get(k, ours["results"][keys[0]])
        sub["results"][k] = [dict(p, timestamp=[p["timestamp"][0] + 1e4 * (i % 3 == 0),
                                                p["timestamp"][1] + 1e4 * (i % 3 == 0)])
                             for p in preds]
    for seed in (0, 11):
        assert teval.run_eval(EvalCfg, sub, paths, rng=random.Random(seed)) == \
            jax_run_eval(seed, EvalCfg, sub, paths)
    assert teval.run_eval(EvalCfg, sub, paths[0]) == jax_run_eval(0, EvalCfg, sub, paths[0])


def test_detection_only_and_bad_input_equal_jax(quality):
    gt, ours = quality
    ref = jeval.ANETCaptionsEvaluator([gt], ours, TIOUS, max_proposals=2,
                                      only_proposals=True).evaluate()
    got = teval.ANETCaptionsEvaluator([gt], ours, TIOUS, max_proposals=2,
                                      only_proposals=True).evaluate()
    assert got == ref and "METEOR" not in got
    for args in (([gt], ours, []), ([gt], {"results": {}}, TIOUS)):
        with pytest.raises(IOError):
            teval.ANETCaptionsEvaluator(*args)


def test_save_submission_writes_what_jax_writes(quality, tmp_path):
    _, ours = quality
    tpost.save_submission(ours, str(tmp_path / "t.json"))
    jpost.save_submission(ours, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
