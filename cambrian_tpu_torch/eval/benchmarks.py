"""The 26-benchmark suite (reference eval/eval/*, eval/README.md).

Each entry maps a dataset record to a prompt + gold answer and names its
scorer. Field mapping follows the benchmarks' published HF layouts with
fallbacks, since records arrive via --dataset_path overrides in zero-egress
environments. CV-Bench's three splits (ade/coco/omni) are first-class
(BASELINE.json configs).
"""

import re
import string
from typing import Dict, List, Optional, Sequence

from .base import (
    Benchmark,
    anls,
    circular_multiple_choice_accuracy,
    contains_match,
    exact_match,
    mathvista_score,
    mme_score,
    mmmu_score,
    multiple_choice_accuracy,
    multiple_choice_accuracy_by_category,
    normalized_edit_similarity,
    register_benchmark,
    relaxed_accuracy,
    vqa_soft_accuracy,
    yes_no_metrics,
)

SHORT_HINT = "\nAnswer the question using a single word or phrase."
MCQ_HINT = "\nAnswer with the option's letter from the given choices directly."


_REQUIRED = object()


def _get(record, *keys, default=_REQUIRED):
    for k in keys:
        if k in record and record[k] is not None:
            return record[k]
    if default is _REQUIRED:
        # strict field resolution: a schema mismatch fails loudly at row 1
        # instead of silently scoring garbage
        raise KeyError(
            f"record has none of the fields {keys}; available: "
            f"{sorted(record)[:25]}")
    return default


def _format_choices(choices: Sequence[str]) -> str:
    letters = string.ascii_uppercase
    return "\n".join(f"{letters[i]}. {c}" for i, c in enumerate(choices))


def _choices_of(record) -> List[str]:
    """Choice list across the suite's real layouts: list-valued
    choices/options/candidates, MMMU's string-repr options
    (mmmu_eval.py:42 parses the quoted items), SEED's choice_a..d columns,
    and mmbench-style per-letter columns."""
    raw = _get(record, "choices", "options", "candidates", default=None)
    if isinstance(raw, str):
        parsed = re.findall(r"'(.*?)'", raw)
        return parsed if parsed else [raw]
    if raw is not None:
        return [str(c) for c in raw]
    seed_cols = [record[k] for k in ("choice_a", "choice_b", "choice_c",
                                    "choice_d")
                 if record.get(k) not in (None, "", "nan")]
    if seed_cols:
        return [str(c) for c in seed_cols]
    return [str(record[k]) for k in ("A", "B", "C", "D", "E", "F")
            if record.get(k) not in (None, "", "nan")]


def _letter_answer(record, choices: Sequence[str], *keys):
    """Gold answer normalized to an option letter where possible: strips the
    CV-Bench/BLINK/MMVP '(A)'/'(a)' wrapping (ade_test.py:52), maps
    ScienceQA's option index and Q-Bench's correct-answer TEXT
    (qbench candidates layout) to their letters."""
    ans = _get(record, *keys, default=None)
    if ans is None:
        return None
    if isinstance(ans, (int,)) and not isinstance(ans, bool):
        return string.ascii_uppercase[ans] if 0 <= ans < 26 else str(ans)
    ans_s = str(ans).strip()
    m = re.match(r"^\(([A-Za-z])\)$", ans_s)
    if m:
        return m.group(1).upper()
    if len(ans_s) > 1 and choices:
        for i, c in enumerate(choices):
            if str(c).strip().lower() == ans_s.lower():
                return string.ascii_uppercase[i]
    if (ans_s.isdigit() and choices and int(ans_s) < len(choices)
            and ans_s not in [str(c).strip() for c in choices]):
        return string.ascii_uppercase[int(ans_s)]  # ai2d-style index strings
    return ans_s


def _mcq_prompt(record) -> dict:
    choices = _choices_of(record)
    pre = _get(record, "prompt", default=None)
    if pre is not None:
        # CV-Bench / BLINK ship the fully formatted question+options in
        # 'prompt' (ade_eval.py:35, blink_eval.py:36) — use it verbatim
        text = f"{pre}{MCQ_HINT}"
    else:
        question = _get(record, "question", "query", "text")
        block = f"\n{_format_choices(choices)}" if choices else ""
        text = f"{question}{block}{MCQ_HINT}"
    return dict(
        text=text,
        image=_first_image(record),
        answer=_letter_answer(record, choices, "answer", "label",
                              "correct_ans"),
        choices=[str(c) for c in choices],
    )


def _first_image(record):
    """The record's image across layouts: 'image' (a list for SEED,
    seed_eval.py:59), 'decoded_image' (MathVista), or 'image_1'
    (MMMU/BLINK multi-image rows; the reference feeds the first,
    blink_eval.py:48)."""
    img = _get(record, "image", "decoded_image", "image_1", default=None)
    if isinstance(img, (list, tuple)):
        img = img[0] if img else None
    return img


def _short_prompt(record) -> dict:
    question = _get(record, "question", "query", "text")
    return dict(
        text=f"{question}{SHORT_HINT}",
        image=_first_image(record),
        answer=_get(record, "answer", "label", "answer_gt", default=""),
        answers=_get(record, "answers", default=None),
    )


def _open_prompt(record) -> dict:
    question = _get(record, "question", "query", "text", "instruction")
    return dict(
        text=question,
        image=_first_image(record),
        answer=_get(record, "answer", "label", default=""),
    )


# --- VQA family -------------------------------------------------------------

register_benchmark(Benchmark(
    name="gqa", dataset="lmms-lab/GQA", split="test",
    build_prompt=_short_prompt, score=exact_match,
))

register_benchmark(Benchmark(
    name="vizwiz", dataset="lmms-lab/VizWiz-VQA", split="val",
    build_prompt=lambda r: dict(
        text=f"{_get(r, 'question')}\nWhen the provided information is "
             f"insufficient, respond with 'Unanswerable'.{SHORT_HINT}",
        image=_get(r, "image"),
        answer=_get(r, "answer", default=""),
        answers=_get(r, "answers"),
    ),
    score=vqa_soft_accuracy,
))

def _textvqa_prompt(record) -> dict:
    """TextVQA folds the OCR tokens into the question (the reference's
    protocol, textvqa_eval.py:35-43)."""
    out = _short_prompt(record)
    ocr = _get(record, "ocr_tokens", default=None)
    if ocr:
        question = _get(record, "question", "query", "text")
        out["text"] = (f"{question}\nReference OCR tokens: "
                       f"{', '.join(str(t) for t in ocr)}{SHORT_HINT}")
    return out


register_benchmark(Benchmark(
    name="textvqa", dataset="lmms-lab/textvqa", split="validation",
    build_prompt=_textvqa_prompt, score=vqa_soft_accuracy,
))

register_benchmark(Benchmark(
    name="pope", dataset="lmms-lab/POPE", split="test",
    build_prompt=_short_prompt, score=yes_no_metrics,
    metric_names=("accuracy", "precision", "recall", "f1"),
    primary_metric="f1",
))

register_benchmark(Benchmark(
    name="mme", dataset="lmms-lab/MME", split="test",
    build_prompt=lambda r: dict(
        text=_get(r, "question"),
        image=_get(r, "image"),
        answer=_get(r, "answer"),
        image_id=_get(r, "question_id", "image_id", "image"),
        category=_get(r, "category", default=""),
    ),
    score=mme_score,
    metric_names=("accuracy", "acc_plus", "score"), primary_metric="score",
))

# --- MCQ family ---------------------------------------------------------------

def _scienceqa_prompt(record) -> dict:
    """ScienceQA includes hint/context fields folded into the question
    (reference eval/eval/scienceqa prompt format)."""
    question = _get(record, "question")
    hint = _get(record, "hint", default="")
    context = f"Context: {hint}\n" if hint else ""
    choices = _choices_of(record)
    answer = _get(record, "answer")
    if isinstance(answer, int):  # scienceqa stores the option index
        answer = string.ascii_uppercase[answer]
    return dict(
        text=f"{context}{question}\n{_format_choices(choices)}{MCQ_HINT}",
        image=_get(record, "image", default=None),  # SQA has text-only rows
        answer=answer,
        choices=[str(c) for c in choices],
    )


register_benchmark(Benchmark(
    name="scienceqa", dataset="derek-thomas/ScienceQA", split="test",
    build_prompt=_scienceqa_prompt, score=multiple_choice_accuracy,
    notes="SQA-IMG subset when filtered to rows with images",
))

def _mcq_prompt_with_category(record) -> dict:
    """MCQ prompt carrying the record's category/subtask for the per-category
    accuracy tables (reference seed/blink *_test.py report per-type rows)."""
    out = _mcq_prompt(record)
    cat = _get(record, "question_type", "question_type_id", "category",
               "sub_task", "subtask", "data_type", default=None)
    if cat is not None:
        out["category"] = str(cat)
    return out


for _name, _ds, _split in [
    ("ai2d", "lmms-lab/ai2d", "test"),
    ("mmstar", "Lin-Chen/MMStar", "val"),
    ("realworldqa", "xai-org/RealworldQA", "test"),
    ("qbench", "q-future/Q-Bench-HF", "dev"),
    ("vstar", "craigwu/vstar_bench", "test"),
]:
    register_benchmark(Benchmark(
        name=_name, dataset=_ds, split=_split,
        build_prompt=_mcq_prompt, score=multiple_choice_accuracy,
    ))


def _mmvp_prompt(record) -> dict:
    """MMVP options arrive as ONE string '(a) yes (b) no'
    (mmvp_eval.py:36-44 splits on '(b)'); answers look like '(a)'."""
    raw = _get(record, "options", "text_options", default=None)
    if isinstance(raw, str) and "(a)" in raw.lower():
        parts = re.split(r"\((b)\)", raw, flags=re.IGNORECASE, maxsplit=1)
        choices = [re.sub(r"^\(a\)\s*", "", parts[0].strip(),
                          flags=re.IGNORECASE)]
        if len(parts) > 2:
            choices.append(parts[2].strip())
        elif len(parts) > 1:
            choices.append(parts[-1].strip())
        record = {**record, "choices": choices}
    return _mcq_prompt(record)


register_benchmark(Benchmark(
    name="mmvp", dataset="MMVP/MMVP", split="test",
    build_prompt=_mmvp_prompt, score=multiple_choice_accuracy,
))

# SEED/BLINK report per-category accuracy alongside the headline number
# (reference seed_test.py / blink question-type tables)
for _name, _ds, _split in [
    ("seed", "lmms-lab/SEED-Bench", "test"),
    ("blink", "BLINK-Benchmark/BLINK", "val"),
]:
    register_benchmark(Benchmark(
        name=_name, dataset=_ds, split=_split,
        build_prompt=_mcq_prompt_with_category,
        score=multiple_choice_accuracy_by_category,
        notes="per-category acc/<name> rows accompany the headline accuracy",
    ))

# MMBench EN/CN: CircularEval over the rotated dev-set copies (official
# protocol; the reference's mmbench_en_eval.py scores per-row only — we
# report that as per_row_accuracy)
def _mmbench_prompt(record) -> dict:
    """MMBench folds a non-'nan' hint before the question
    (mmbench_en_eval.py:41-42) and carries l2-category for tables."""
    out = _mcq_prompt(record)
    hint = _get(record, "hint", default=None)
    if hint not in (None, "", "nan"):
        out["text"] = f"{hint}\n{out['text']}"
    cat = _get(record, "l2-category", "l2_category", "category", default=None)
    if cat is not None:
        out["category"] = str(cat)
    return out


for _name, _ds in [("mmbench_en", "lmms-lab/MMBench_EN"),
                   ("mmbench_cn", "lmms-lab/MMBench_CN")]:
    register_benchmark(Benchmark(
        name=_name, dataset=_ds, split="dev",
        build_prompt=_mmbench_prompt, score=circular_multiple_choice_accuracy,
    ))

# CV-Bench: the reference's ade/omni/coco splits (ade_eval.py:75 loads
# benchmark_ade_manual etc.)
for _name in ["ade", "coco", "omni"]:
    register_benchmark(Benchmark(
        name=_name, dataset=f"nyu-visionx/CV-Bench", split="test",
        build_prompt=_mcq_prompt, score=multiple_choice_accuracy,
        notes=f"CV-Bench {_name} split",
    ))

def _mmmu_category(record) -> Optional[str]:
    """Subject from the MMMU row id 'validation_Art_Theory_12' -> 'Art_Theory'
    (reference mmmu_test.py groups by this subject)."""
    rid = str(_get(record, "id", "question_id", default=""))
    parts = rid.split("_")
    if len(parts) >= 3:
        return "_".join(parts[1:-1])
    return _get(record, "subfield", "category", default=None)


def _mmmu_prompt(record) -> dict:
    qtype = _get(record, "question_type", default="multiple-choice")
    out = _mcq_prompt(record) if qtype == "multiple-choice" \
        else _open_prompt(record)
    out["question_type"] = qtype
    # open rows may carry a list of acceptable golds
    ans = _get(record, "answer", "label", default=out.get("answer"))
    if isinstance(ans, (list, tuple)):
        out["answers"] = [str(a) for a in ans]
        out["answer"] = str(ans[0]) if ans else ""
    cat = _mmmu_category(record)
    if cat:
        out["category"] = cat
    return out


register_benchmark(Benchmark(
    name="mmmu", dataset="lmms-lab/MMMU", split="validation",
    build_prompt=_mmmu_prompt,
    score=mmmu_score,
    notes="MCQ by extracted letter; open rows by exact match over extracted "
          "candidate spans; per-subject acc/<name> rows",
))

# --- document / OCR family ---------------------------------------------------

register_benchmark(Benchmark(
    name="docvqa", dataset="lmms-lab/DocVQA", config="DocVQA",
    split="validation",
    build_prompt=_short_prompt, score=anls,
    metric_names=("anls",), primary_metric="anls",
))

register_benchmark(Benchmark(
    name="infovqa", dataset="lmms-lab/DocVQA", config="InfographicVQA",
    split="validation",
    build_prompt=_short_prompt, score=anls,
    metric_names=("anls",), primary_metric="anls",
    notes="InfographicVQA config of the lmms-lab/DocVQA dataset",
))

register_benchmark(Benchmark(
    name="stvqa", dataset="lmms-lab/ST-VQA", split="test",
    build_prompt=_short_prompt, score=anls,
    metric_names=("anls",), primary_metric="anls",
))

register_benchmark(Benchmark(
    name="chartqa", dataset="lmms-lab/ChartQA", split="test",
    build_prompt=_short_prompt, score=relaxed_accuracy,
))

register_benchmark(Benchmark(
    name="ocrbench", dataset="echo840/OCRBench", split="test",
    build_prompt=_short_prompt, score=contains_match,
))

def _synthdog_answer(record) -> str:
    """synthdog's ground_truth is a JSON string
    '{"gt_parse": {"text_sequence": ...}}' (synthdog_eval.py:97-98)."""
    raw = _get(record, "ground_truth", "answer", default="")
    if isinstance(raw, str) and raw.lstrip().startswith("{"):
        import json as _json

        try:
            return _json.loads(raw)["gt_parse"]["text_sequence"]
        except (ValueError, KeyError, TypeError):
            return raw
    if isinstance(raw, dict):
        return raw.get("gt_parse", {}).get("text_sequence", str(raw))
    return raw


register_benchmark(Benchmark(
    name="synthdog", dataset="naver-clova-ix/synthdog-en", split="validation",
    build_prompt=lambda r: dict(
        text="Read all the text in the image.",
        image=_get(r, "image"),
        answer=_synthdog_answer(r),
    ),
    score=normalized_edit_similarity,
    metric_names=("similarity",), primary_metric="similarity",
))

# --- open-ended / judged family -----------------------------------------------

def _mmvet_prompt(record) -> dict:
    out = _open_prompt(record)
    # official ids look like "v1_0" (mmvet_test.py keys the submission on them)
    out["submission_id"] = str(_get(record, "id", "question_id", default=""))
    return out


def _mmvet_submission(records: List[dict]) -> Dict[str, str]:
    """{id: raw prediction} for the official MM-Vet GPT-4 grader portal —
    the reference's real scoring product (eval/eval/mmvet/mmvet_test.py:35-38);
    the rule-based score below is only a local proxy."""
    return {
        str(r.get("submission_id") or r.get("question_id")): r["prediction"]
        for r in records
    }


register_benchmark(Benchmark(
    name="mmvet", dataset="lmms-lab/MMVet", split="test",
    build_prompt=_mmvet_prompt, score=contains_match,
    submission=_mmvet_submission,
    notes="reference scores MM-Vet with a GPT-4 judge; rule-based proxy here "
          "+ official {model}_mmvet_submission.json artifact",
))

def _mathvista_prompt(record) -> dict:
    """MathVista row -> prompt. Multi-choice golds map to option letters
    (what the reference answer rows carry, mathvista_eval.py:106-111);
    category rides along from metadata for the scorer's per-category table
    and question_type for format-aware consumers."""
    qtype = _get(record, "question_type", default="free_form")
    out = _mcq_prompt(record) if qtype == "multi_choice" \
        else _short_prompt(record)
    out["question_type"] = qtype
    if qtype == "multi_choice" and out.get("choices"):
        # gold arrives as the choice TEXT; the reference answer rows carry
        # the option letter (reverse_dict, mathvista_eval.py:106-111) — map
        # unconditionally, incl. single-character choices ("3" -> "A")
        # which the shared _letter_answer leaves alone
        raw = str(_get(record, "answer", default=out.get("answer"))).strip()
        for i, c in enumerate(out["choices"]):
            if str(c).strip().lower() == raw.lower():
                out["answer"] = string.ascii_uppercase[i]
                break
    meta = _get(record, "metadata", default=None)
    cat = record.get("category") or (
        meta.get("category") if isinstance(meta, dict) else None)
    if cat:
        out["category"] = str(cat)
    return out


register_benchmark(Benchmark(
    name="mathvista", dataset="AI4Math/MathVista", split="testmini",
    build_prompt=_mathvista_prompt,
    score=mathvista_score,
    notes="reference extracts answers with GPT; regex extraction here",
))
