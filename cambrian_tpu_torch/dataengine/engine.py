"""Data-engine pipeline stages (reference dataengine/README.md:43-55):

1. ``generate_topics``        fields/subfields -> 20 sub-topics each (GPT)
2. ``process_json_files``     normalize the per-field topic JSONs
3. ``clean_and_rename_files`` slugify/clean the topic files
4. ``wiki_page_flow``         topic -> wikipedia page + images (+ Google CSE)
5. ``generate_qa_pairs``      page text -> QA pairs (GPT)
6. ``generate_vqa``           QA + images -> conversation-format VQA JSON

The LLM calls go through :func:`chat_completion` (plain REST, no `openai`
package dependency). Reference produced the 161k science-VQA set this way
(dataengine/README.md:172-173).
"""

import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

OPENAI_URL = "https://api.openai.com/v1/chat/completions"
WIKI_API_URL = "https://en.wikipedia.org/w/api.php"
CSE_URL = "https://www.googleapis.com/customsearch/v1"


def chat_completion(messages: List[dict], model: str = "gpt-4-turbo",
                    api_key: Optional[str] = None, max_retries: int = 3) -> str:
    """Minimal OpenAI chat call over REST."""
    import requests

    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise EnvironmentError("OPENAI_API_KEY is required for this stage")
    for attempt in range(max_retries):
        try:
            r = requests.post(
                OPENAI_URL,
                headers={"Authorization": f"Bearer {api_key}"},
                json={"model": model, "messages": messages},
                timeout=120,
            )
            r.raise_for_status()
            return r.json()["choices"][0]["message"]["content"]
        except Exception as e:
            if attempt == max_retries - 1:
                raise
            logger.warning("chat_completion retry %d: %s", attempt, e)
            time.sleep(2 ** attempt)


# --------------------------------------------------------------------------
# stage 1: topics
# --------------------------------------------------------------------------

TOPIC_SYSTEM_PROMPT = (
    "You will be given a list of fields and subfields. For each subfield, "
    "generate a detailed list of 20 sub-topics in JSON format."
)


def generate_topics(data_file_path: str, output_dir: str,
                    model: str = "gpt-4-turbo") -> List[str]:
    """(reference generate_topics.py): 'Field: subfield' lines -> one topic
    JSON per field."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    with open(data_file_path) as f:
        lines = f.read().strip().split("\n")
    for line in lines:
        if ": " not in line:
            continue
        topic, _ = line.split(": ", 1)
        content = chat_completion(
            [{"role": "system", "content": TOPIC_SYSTEM_PROMPT},
             {"role": "user", "content": line}],
            model=model,
        )
        path = os.path.join(output_dir, f"{topic.replace(' ', '_')}.json")
        with open(path, "w") as out:
            out.write(content)
        written.append(path)
    return written


# --------------------------------------------------------------------------
# stage 2+3: normalize and clean topic files (pure)
# --------------------------------------------------------------------------

def _extract_json(text: str):
    """Pull the first JSON object/array out of an LLM reply."""
    text = text.strip()
    if text.startswith("```"):
        text = re.sub(r"^```[a-z]*\n?", "", text)
        text = re.sub(r"\n?```$", "", text)
    start = min((i for i in (text.find("{"), text.find("[")) if i >= 0),
                default=0)
    return json.loads(text[start:])


def process_json_files(input_dir: str, output_dir: str) -> List[str]:
    """(reference process_json_files.py): parse each topic reply into
    {subfield: [topics]} and re-emit normalized JSON."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for fname in sorted(os.listdir(input_dir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(input_dir, fname)) as f:
            raw = f.read()
        try:
            data = _extract_json(raw)
        except Exception as e:
            logger.warning("skipping %s: %s", fname, e)
            continue
        normalized: Dict[str, List[str]] = {}
        if isinstance(data, dict):
            for key, value in data.items():
                if isinstance(value, list):
                    normalized[key] = [str(v) for v in value]
                elif isinstance(value, dict):
                    for k2, v2 in value.items():
                        if isinstance(v2, list):
                            normalized[k2] = [str(v) for v in v2]
        elif isinstance(data, list):
            normalized[os.path.splitext(fname)[0]] = [str(v) for v in data]
        path = os.path.join(output_dir, fname)
        with open(path, "w") as out:
            json.dump(normalized, out, indent=2)
        written.append(path)
    return written


def _slugify(name: str) -> str:
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", name).strip("_")
    return re.sub(r"_+", "_", slug)


def clean_and_rename_files(directory: str) -> List[str]:
    """(reference clean_and_rename_files.py): slugify file names in place."""
    renamed = []
    for fname in sorted(os.listdir(directory)):
        clean = _slugify(fname)
        if clean != fname:
            os.rename(os.path.join(directory, fname),
                      os.path.join(directory, clean))
        renamed.append(clean)
    return renamed


# --------------------------------------------------------------------------
# stage 4: wiki / google harvesting
# --------------------------------------------------------------------------

def google_search(query: str, num: int = 10,
                  api_key: Optional[str] = None,
                  cse_id: Optional[str] = None) -> List[dict]:
    """Google CSE over REST (reference wikiflow.py:27-45, without the
    googleapiclient dependency)."""
    import requests

    api_key = api_key or os.environ.get("GOOGLE_API_KEY")
    cse_id = cse_id or os.environ.get("GOOGLE_SE_ID")
    if not (api_key and cse_id):
        raise EnvironmentError("GOOGLE_API_KEY and GOOGLE_SE_ID are required")
    r = requests.get(CSE_URL, params={"key": api_key, "cx": cse_id,
                                      "q": query, "num": num}, timeout=30)
    r.raise_for_status()
    items = r.json().get("items", [])
    return [{"title": i.get("title", ""), "url": i.get("link", ""),
             "description": i.get("snippet", "")} for i in items]


def wiki_page_flow(topic: str, output_dir: str, max_images: int = 8,
                   rate_limit_s: float = 0.5) -> Optional[dict]:
    """(reference wikiflow.py + generate_qa.py download half): fetch the
    topic's wikipedia extract and images; write {topic}.json + images/."""
    import requests

    os.makedirs(output_dir, exist_ok=True)
    session = requests.Session()

    search = session.get(WIKI_API_URL, params={
        "action": "query", "list": "search", "srsearch": topic,
        "format": "json",
    }, timeout=30).json()
    hits = search.get("query", {}).get("search", [])
    if not hits:
        return None
    title = hits[0]["title"]
    time.sleep(rate_limit_s)

    page = session.get(WIKI_API_URL, params={
        "action": "query", "prop": "extracts|images", "explaintext": 1,
        "titles": title, "format": "json", "imlimit": max_images,
    }, timeout=30).json()
    pages = page.get("query", {}).get("pages", {})
    if not pages:
        return None
    pdata = next(iter(pages.values()))
    record = {
        "topic": topic,
        "title": title,
        "extract": pdata.get("extract", ""),
        "images": [],
    }
    img_dir = os.path.join(output_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    for img in pdata.get("images", [])[:max_images]:
        img_title = img.get("title", "")
        if not img_title.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        time.sleep(rate_limit_s)
        info = session.get(WIKI_API_URL, params={
            "action": "query", "titles": img_title, "prop": "imageinfo",
            "iiprop": "url", "format": "json",
        }, timeout=30).json()
        ipages = info.get("query", {}).get("pages", {})
        url = next(iter(ipages.values())).get("imageinfo", [{}])[0].get("url")
        if not url:
            continue
        fname = _slugify(os.path.basename(url))
        try:
            data = session.get(url, timeout=60,
                               headers={"User-Agent": "cambrian-tpu/0.1"}).content
            with open(os.path.join(img_dir, fname), "wb") as f:
                f.write(data)
            record["images"].append(fname)
        except Exception as e:
            logger.warning("image download failed %s: %s", url, e)
    path = os.path.join(output_dir, f"{_slugify(topic)}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


# --------------------------------------------------------------------------
# stage 5: QA generation
# --------------------------------------------------------------------------

QA_SYSTEM_PROMPT = (
    "You are given an article. Generate question-answer pairs that test "
    "understanding of the article's visual and factual content. Return a "
    "JSON list of objects with 'question' and 'answer' keys."
)


def generate_qa_pairs(extract: str, num_pairs: int = 5,
                      model: str = "gpt-4-turbo") -> List[dict]:
    """(reference generate_qa.py GPT half)."""
    content = chat_completion(
        [{"role": "system", "content": QA_SYSTEM_PROMPT},
         {"role": "user",
          "content": f"Generate {num_pairs} QA pairs:\n\n{extract[:6000]}"}],
        model=model,
    )
    pairs = _extract_json(content)
    return [p for p in pairs if isinstance(p, dict)
            and "question" in p and "answer" in p]


# --------------------------------------------------------------------------
# stage 6: VQA assembly (pure)
# --------------------------------------------------------------------------

def generate_vqa(records: Sequence[dict], output_file: str,
                 id_prefix: str = "dataengine") -> List[dict]:
    """(reference generate_vqa.py): topic records with images + QA pairs ->
    training-format conversations (first turn carries <image>)."""
    out = []
    idx = 0
    for record in records:
        images = record.get("images", [])
        for qa in record.get("qa_pairs", []):
            if not images:
                continue
            out.append({
                "id": f"{id_prefix}-{idx}",
                "image": images[idx % len(images)],
                "conversations": [
                    {"from": "human", "value": "<image>\n" + qa["question"]},
                    {"from": "gpt", "value": qa["answer"]},
                ],
            })
            idx += 1
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    with open(output_file, "w") as f:
        json.dump(out, f, indent=2)
    return out


def run_pipeline(fields_file: str, workdir: str, model: str = "gpt-4-turbo",
                 num_pairs: int = 5):
    """End-to-end pipeline over all six stages."""
    topics_dir = os.path.join(workdir, "topics_raw")
    norm_dir = os.path.join(workdir, "topics")
    pages_dir = os.path.join(workdir, "pages")
    generate_topics(fields_file, topics_dir, model=model)
    process_json_files(topics_dir, norm_dir)
    clean_and_rename_files(norm_dir)
    records = []
    for fname in sorted(os.listdir(norm_dir)):
        with open(os.path.join(norm_dir, fname)) as f:
            topics = f.read()
        for topic_list in json.loads(topics).values():
            for topic in topic_list:
                rec = wiki_page_flow(topic, pages_dir)
                if rec and rec["extract"]:
                    rec["qa_pairs"] = generate_qa_pairs(rec["extract"],
                                                        num_pairs, model)
                    records.append(rec)
    return generate_vqa(records, os.path.join(workdir, "vqa.json"))
