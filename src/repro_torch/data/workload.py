"""Synthetic query workload generator (the paper's "query logs of a
production MLaaS cloud provider" stand-in, §3.2).

Each query is built from a task-type template + domain lexicon words +
complexity-controlled filler.  The generator records the ground-truth
TaskSignature (the label the analyzer is trained against) and a
per-model ground-truth quality table used by the routing benchmarks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.preferences import DOMAINS, TASK_TYPES, TaskSignature

# ----------------------------------------------------------------------
# templates & lexicons
# ----------------------------------------------------------------------

TEMPLATES: Dict[str, List[str]] = {
    "chat": ["hello can you help me with {topic}",
             "i have a question about {topic}",
             "what do you think about {topic}"],
    "code": ["write a python function that computes {topic}",
             "fix the bug in this code {blob}",
             "refactor this module for readability {blob}"],
    "reasoning": ["solve this step by step {blob}",
                  "prove that {topic} holds for all cases",
                  "which option is correct and why {blob}"],
    "summarization": ["summarize the following article {blob}",
                      "give me a tl dr of this document {blob}",
                      "condense these meeting notes {blob}"],
    "classification": ["find the sentiment of the passage {blob}",
                       "classify this ticket into a category {blob}",
                       "label the intent of this message {blob}"],
    "translation": ["translate this passage to german {blob}",
                    "convert the following text into french {blob}",
                    "translate to spanish keeping the tone {blob}"],
    "transcription": ["transcribe the attached audio about {topic}",
                      "produce a transcript of this recording {topic}",
                      "caption the spoken audio {topic}"],
    "vqa": ["looking at the image what is {topic}",
            "answer the question about the attached picture {topic}",
            "from the screenshot determine {topic}"],
    "captioning": ["describe the attached image of {topic}",
                   "write alt text for this picture of {topic}",
                   "caption this photo about {topic}"],
    "creative-writing": ["write a short story about {topic}",
                         "compose a poem on {topic}",
                         "draft a fictional dialogue about {topic}"],
    "long-context": ["using the entire report below answer {topic} {blob}",
                     "search this long document for {topic} {blob}",
                     "cross reference the chapters below about {topic} {blob}"],
}

DOMAIN_LEXICON: Dict[str, List[str]] = {
    "general": ["weather", "travel", "cooking", "music", "history",
                "sports", "gardening"],
    "software": ["kubernetes", "compiler", "database", "frontend", "api",
                 "microservice", "deployment", "regression"],
    "finance": ["portfolio", "derivatives", "equity", "hedging", "ledger",
                "liquidity", "arbitrage", "quarterly"],
    "legal": ["contract", "liability", "statute", "plaintiff", "clause",
              "compliance", "jurisdiction", "tort"],
    "healthcare": ["diagnosis", "dosage", "radiology", "oncology",
                   "symptom", "clinical", "pathology", "triage"],
    "multilingual": ["german", "mandarin", "localization", "dialect",
                     "idiom", "bilingual", "transliteration"],
}

_FILLER = ["the", "report", "shows", "that", "we", "observed", "several",
           "items", "during", "review", "and", "noted", "further", "points",
           "for", "discussion", "in", "section"]
_HARD_MARKERS = ["however", "sarcastically", "notwithstanding", "paradox",
                 "ambiguous", "nested", "caveat", "irony", "subtle",
                 "counterintuitive"]


@dataclass(frozen=True)
class QueryRecord:
    text: str
    sig: TaskSignature          # ground truth implicit preferences
    id: int = 0


def _complexity_blob(rng, complexity: float, domain_words) -> Tuple[str, int]:
    """Filler blob whose length/markers encode the complexity."""
    n_fill = int(10 + complexity * 120)
    words = list(rng.choice(_FILLER, n_fill))
    n_hard = int(round(complexity * 6))
    for _ in range(n_hard):
        words.insert(int(rng.integers(0, len(words))),
                     str(rng.choice(_HARD_MARKERS)))
    for _ in range(3):
        words.insert(int(rng.integers(0, len(words))),
                     str(rng.choice(domain_words)))
    return " ".join(words), n_hard


def make_query(rng: np.random.Generator, *, task_type: Optional[str] = None,
               domain: Optional[str] = None,
               complexity: Optional[float] = None, qid: int = 0
               ) -> QueryRecord:
    tt = task_type or str(rng.choice(TASK_TYPES))
    dm = domain or str(rng.choice(DOMAINS))
    cx = float(rng.random()) if complexity is None else float(complexity)
    lex = DOMAIN_LEXICON[dm]
    template = str(rng.choice(TEMPLATES[tt]))
    blob, _ = _complexity_blob(rng, cx, lex)
    topic = " ".join(rng.choice(lex, 2))
    text = template.format(topic=topic, blob=blob)
    # quantize ground-truth complexity to what is recoverable from text
    cx_obs = min(1.0, (len(text.split()) - 10) / 130.0 * 0.7
                 + sum(text.count(m) for m in _HARD_MARKERS) / 6.0 * 0.3 + 0.0)
    sig = TaskSignature(task_type=tt, domain=dm,
                        complexity=round(max(0.0, cx_obs), 4))
    return QueryRecord(text=text, sig=sig, id=qid)


def inflate_query(rec: QueryRecord, target_words: int,
                  rng: np.random.Generator) -> QueryRecord:
    """Pad a query's middle with context filler to ``target_words``
    keeping the task description at the edges (the paper's 10k+-word
    long-query shape).  The signature is unchanged: the blob is context,
    not task."""
    words = rec.text.split()
    need = target_words - len(words)
    if need <= 0:
        return rec
    blob = list(rng.choice(_FILLER, need))
    cut = max(len(words) // 2, 1)
    return dataclasses.replace(
        rec, text=" ".join(words[:cut] + blob + words[cut:]))


def make_workload(n: int, seed: int = 0, *, task_type=None, domain=None,
                  complexity=None, long_frac: float = 0.0,
                  long_words: Tuple[int, int] = (200, 2000)
                  ) -> List[QueryRecord]:
    """``long_frac`` of the queries are inflated to long-context shape
    (uniform word count in ``long_words``) — the paper's production
    query-log mix."""
    rng = np.random.default_rng(seed)
    out = [make_query(rng, task_type=task_type, domain=domain,
                      complexity=complexity, qid=i) for i in range(n)]
    if long_frac:
        for i in range(n):
            if rng.random() < long_frac:
                out[i] = inflate_query(
                    out[i], int(rng.integers(*long_words)), rng)
    return out


# ----------------------------------------------------------------------
# ground-truth model quality (for routing benchmarks)
# ----------------------------------------------------------------------

def meta_of(entry) -> Dict:
    """The ``quality_of`` meta dict for an MRES-style entry (anything
    with name / raw_metrics / task_types / domains attributes)."""
    return {"name": entry.name,
            "accuracy": float(entry.raw_metrics.get("accuracy", 0.5)),
            "task_types": tuple(entry.task_types),
            "domains": tuple(entry.domains)}


def quality_of(entry_meta: Dict, sig: TaskSignature) -> float:
    """Synthetic probability that a model answers a query well.

    Capability model: a model with catalog accuracy ``a`` and domain /
    task-type tags answers with quality a - penalty(complexity beyond
    capability) - penalty(out-of-domain).  Deterministic given
    (entry, sig) so experiments are reproducible.
    """
    acc = float(entry_meta.get("accuracy", 0.5))
    cap = acc                                  # capability proxy
    q = acc
    if sig.complexity > cap:
        q -= 0.8 * (sig.complexity - cap)
    if sig.task_type not in entry_meta.get("task_types", ()):  # wrong tool
        q -= 0.25
    if sig.domain not in entry_meta.get("domains", ()):
        q -= 0.15
    return float(np.clip(q, 0.0, 1.0))
