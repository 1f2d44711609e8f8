"""Ask pipeline: retrieve → expand → prompt → (routed) generate → post
(port of the JAX package's ``pipeline/ask.py``). The routed path decides
with ``Runtime.router`` and answers through ``Runtime.loader``.

Call-flow parity with the reference (rag/pipeline/rag.py:511-714):
retrieval with metadata filters, neighbor expansion + per-doc diversity
caps, target-language resolution (forced > configured > question
detection), 3500-char context budget, routed or legacy generation with an
"I don't know" general-answer fallback, optional translate-on-miss (legacy
path), and optional strict-citation enforcement (skipped for fallback
answers, which never saw the context). The legacy path generates with
``Runtime.runner``, built once per runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from classmate_rag_tpu_torch.generation import (
    build_general_messages,
    build_grounded_messages,
    enforce_citations,
    format_context_blocks,
)
from classmate_rag_tpu_torch.metadata import DocumentMetadata
from classmate_rag_tpu_torch.pipeline.runtime import Runtime, get_runtime
from classmate_rag_tpu_torch.retrieval import expand_with_neighbors
from classmate_rag_tpu_torch.routing.types import ROUTES, Route, RouteDecision
from classmate_rag_tpu_torch.routing.prompts import system_prompt_for
from classmate_rag_tpu_torch.utils import detect_lang_tag


@dataclass
class AskResult:
    question: str
    answer: str
    language: str
    top_k: int
    sources: List[str]
    retrieved: List[Dict[str, object]]
    filters_applied: Dict[str, object]
    hybrid: bool
    route: Optional[str] = None
    route_reason: Optional[str] = None


def _looks_unknown(answer: str, lang: str) -> bool:
    """Reference-exact unknown-answer heuristic (rag/pipeline/rag.py:
    462-469), substring semantics included: "non so" also matches inside
    "non sono"/"non solo" — a documented reference quirk that can flip a
    grounded Italian answer to the general fallback. Kept byte-for-byte
    for behavioral parity; do NOT tighten without diverging from the
    reference."""
    a = (answer or "").strip().lower()
    if not a:
        return True
    if lang == "it":
        return "non lo so" in a or "non so" in a
    return "i don't know" in a or "i dont know" in a


def _needs_translation(answer: str, target_lang: str) -> bool:
    if not answer.strip():
        return False
    detected = detect_lang_tag(answer)
    return detected in ("en", "it") and detected != target_lang


def _translate_text(text: str, target_lang: str, runner) -> str:
    """Translate via the active runner, preserving [n] citations."""
    if not text.strip():
        return text
    if target_lang == "it":
        system = (
            "Sei un traduttore. Traduci fedelmente in italiano il seguente "
            "testo. Mantieni esattamente i riferimenti tra parentesi quadre "
            "come [1], [2]."
        )
        prompt = f"Testo da tradurre:\n{text}"
    else:
        system = (
            "You are a translator. Translate the following text faithfully "
            "into English. Preserve bracketed citations like [1], [2] "
            "exactly."
        )
        prompt = f"Text to translate:\n{text}"
    messages = [
        {"role": "system", "content": system},
        {"role": "user", "content": prompt},
    ]
    out = runner.chat(messages, temperature=0.0, top_p=1.0, max_tokens=2048)
    return out.strip() or text


def _apply_expansion_and_diversity(results, rt: Runtime):
    cfg = rt.cfg
    radius = cfg.neighbor_radius if cfg.enable_neighbor_expansion else 0
    return expand_with_neighbors(
        results, rt.catalog, radius=radius, max_per_doc=cfg.doc_diversity_cap,
    )


def ask_question(
    *,
    question: str,
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    forced_subject: Optional[str] = None,
    runtime: Optional[Runtime] = None,
) -> AskResult:
    from classmate_rag_tpu_torch.utils.metrics import metrics

    with metrics.timer("ask"):
        return _ask_question(
            question=question, filters=filters, top_k=top_k,
            hybrid=hybrid, forced_subject=forced_subject, runtime=runtime,
        )


def retrieve_batch_for_ask(
    *,
    questions: List[str],
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    runtime: Optional[Runtime] = None,
):
    """DEVICE phase of the batched ask: ONE fused retrieval dispatch for
    all questions (they share the filter set). Returns the per-question
    result lists, already materialized on host — callers holding a device
    lock can release it before the generation tail."""
    rt = runtime or get_runtime()
    where = filters.to_dict()
    return rt.retriever.retrieve_batch(
        questions=list(questions), filters=where, top_k=int(top_k),
        hybrid=bool(hybrid),
    )


def finish_ask_batch(
    *,
    questions: List[str],
    batched,
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    forced_subject: Optional[str] = None,
    runtime: Optional[Runtime] = None,
) -> List[AskResult]:
    """HOST tail of the batched ask: expansion, prompting, generation,
    citations. Questions that decide onto the same route generate in ONE
    batched chat (one batched decode on the decoder runner; a loop on
    host-side runners). Safe to run outside the serving device lock."""
    rt = runtime or get_runtime()
    where = filters.to_dict()
    results_list = [
        _apply_expansion_and_diversity(list(r), rt) for r in batched
    ]
    return _finish_ask_many(
        questions=questions, results_list=results_list, filters=filters,
        where=where, top_k=top_k, hybrid=hybrid,
        forced_subject=forced_subject, rt=rt,
    )


def ask_question_batch(
    *,
    questions: List[str],
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    forced_subject: Optional[str] = None,
    runtime: Optional[Runtime] = None,
) -> List[AskResult]:
    """Batched ask: retrieve_batch_for_ask + finish_ask_batch in one call
    (the serving daemon invokes the phases separately so the device lock
    covers only retrieval)."""
    from classmate_rag_tpu_torch.utils.metrics import metrics

    rt = runtime or get_runtime()
    with metrics.timer("ask_batch"):
        batched = retrieve_batch_for_ask(
            questions=questions, filters=filters, top_k=top_k,
            hybrid=hybrid, runtime=rt,
        )
        return finish_ask_batch(
            questions=questions, batched=batched, filters=filters,
            top_k=top_k, hybrid=hybrid, forced_subject=forced_subject,
            runtime=rt,
        )


def _ask_question(
    *,
    question: str,
    filters: DocumentMetadata,
    top_k: int = 8,
    hybrid: bool = True,
    forced_subject: Optional[str] = None,
    runtime: Optional[Runtime] = None,
) -> AskResult:
    rt = runtime or get_runtime()
    where = filters.to_dict()
    results = rt.retriever.retrieve(
        question=question, filters=where, top_k=int(top_k),
        hybrid=bool(hybrid),
    )
    results = _apply_expansion_and_diversity(list(results), rt)
    return _finish_ask(
        question=question, results=results, filters=filters, where=where,
        top_k=top_k, hybrid=hybrid, forced_subject=forced_subject, rt=rt,
    )


def _finish_ask(
    *,
    question: str,
    results: List[Dict[str, object]],
    filters: DocumentMetadata,
    where: Dict[str, object],
    top_k: int,
    hybrid: bool,
    forced_subject: Optional[str],
    rt: Runtime,
) -> AskResult:
    return _finish_ask_many(
        questions=[question], results_list=[results], filters=filters,
        where=where, top_k=top_k, hybrid=hybrid,
        forced_subject=forced_subject, rt=rt,
    )[0]


def _general_messages_for(question: str, target_lang: str):
    general = build_general_messages(question)
    if target_lang == "it":
        general[0] = {
            "role": "system",
            "content": "Sei un assistente generico. Rispondi alla "
                       "domanda dell'utente.",
        }
    return general


def _finish_ask_many(
    *,
    questions: List[str],
    results_list: List[List[Dict[str, object]]],
    filters: DocumentMetadata,
    where: Dict[str, object],
    top_k: int,
    hybrid: bool,
    forced_subject: Optional[str],
    rt: Runtime,
) -> List[AskResult]:
    """The ask tail for one or many questions. Same semantics per question
    as the reference's single-ask flow; generation groups questions by
    decided route and answers each group through ONE chat_batch call of
    the runtime's runner (one batched decode on the decoder)."""
    cfg = rt.cfg
    n = len(questions)

    forced_lang = None
    if filters.language and filters.language.value in ("en", "it"):
        forced_lang = filters.language.value
    default = str(cfg.default_language)

    langs: List[str] = []
    contexts: List[str] = []
    provs: List[List[str]] = []
    for q, results in zip(questions, results_list):
        if forced_lang:
            langs.append(forced_lang)
        elif default in ("en", "it"):
            langs.append(default)
        else:
            langs.append(detect_lang_tag(q))
        context_text, provenance = format_context_blocks(
            results, max_total_chars=cfg.context_budget_chars
        )
        contexts.append(context_text)
        provs.append(provenance)

    strict = cfg.strict_citations
    add_sources = cfg.append_sources_block

    # ---- Routed path -------------------------------------------------
    if cfg.enable_routing:
        from classmate_rag_tpu_torch.metadata.schema import _normalize_subject

        forced_route: Optional[Route] = None
        candidate = forced_subject or filters.subject
        if isinstance(candidate, str) and candidate not in ROUTES:
            # Callers hand in raw user input (CLI --subject, the serve
            # payload): run the same EN/IT alias normalization ingest
            # applies ("matematica" -> "math") so an alias actually
            # forces the route instead of silently doing nothing.
            candidate = _normalize_subject(candidate) or candidate
        if isinstance(candidate, str) and candidate in ROUTES:
            forced_route = candidate  # type: ignore[assignment]

        # ONE classifier encode for the whole batch: a per-question
        # decide() costs a full E5 forward + host fetch each, serialized
        # in the host tail the device lock was released to overlap.
        decisions: List[RouteDecision] = rt.router.decide_batch(
            questions,
            [
                [r.get("metadata") or {} for r in results]
                for results in results_list
            ],
            forced_subject=forced_route,
        )
        messages_list = [
            [
                {"role": "system",
                 "content": system_prompt_for(d.route, language=lang)},
                {"role": "user",
                 "content": f"Context:\n{ctx}\n\nQuestion:\n{q}\n\nAnswer:"},
            ]
            for q, d, lang, ctx in zip(questions, decisions, langs, contexts)
        ]

        def chat_grouped(idxs: List[int], msgs: List) -> Dict[int, str]:
            by_route: Dict[str, List[int]] = {}
            for pos, i in enumerate(idxs):
                by_route.setdefault(decisions[i].route, []).append(pos)
            out: Dict[int, str] = {}
            for route, positions in by_route.items():
                answers = rt.loader.chat_batch(
                    route=route,
                    messages_list=[msgs[p] for p in positions],
                    max_tokens=cfg.route_max_tokens,
                    temperature=cfg.route_temperature,
                    top_p=cfg.route_top_p,
                )
                for p, a in zip(positions, answers):
                    out[idxs[p]] = a.strip()
            return out

        answers_map = chat_grouped(list(range(n)), messages_list)
        answers = [answers_map[i] for i in range(n)]

        from_fallback = [False] * n
        fb = [i for i in range(n) if _looks_unknown(answers[i], langs[i])]
        if fb:
            fb_msgs = [
                _general_messages_for(questions[i], langs[i]) for i in fb
            ]
            fb_map = chat_grouped(fb, fb_msgs)
            for i in fb:
                answers[i] = fb_map[i]
                from_fallback[i] = True

        out_results: List[AskResult] = []
        for i in range(n):
            answer = answers[i]
            sources_title = "Sources" if langs[i] == "en" else "Fonti"
            if strict and not from_fallback[i]:
                answer = enforce_citations(
                    answer, provs[i],
                    add_sources_block=add_sources,
                    sources_title=sources_title,
                )
            out_results.append(AskResult(
                question=questions[i], answer=answer, language=langs[i],
                top_k=int(top_k),
                sources=[] if from_fallback[i] else provs[i],
                retrieved=results_list[i], filters_applied=where,
                hybrid=bool(hybrid),
                route=decisions[i].route, route_reason=decisions[i].reason,
            ))
        return out_results

    # ---- Legacy single-model path ------------------------------------
    runner = rt.runner

    def runner_chat_batch(msgs: List, **kw) -> List[str]:
        if hasattr(runner, "chat_batch"):
            return list(runner.chat_batch(msgs, **kw))
        return [runner.chat(m, **kw) for m in msgs]

    messages_list = [
        build_grounded_messages(
            question=q, context_text=ctx, citations_required=True
        )
        for q, ctx in zip(questions, contexts)
    ]
    answers = [
        a.strip() for a in runner_chat_batch(
            messages_list, max_tokens=cfg.llm_max_tokens,
            temperature=cfg.llm_temperature, top_p=cfg.llm_top_p,
        )
    ]
    from_fallback = [False] * n
    fb = [i for i in range(n) if _looks_unknown(answers[i], langs[i])]
    if fb:
        # Same sampling knobs as the primary call: the reference's
        # fallback shares the runner defaults with its primary
        # (rag.py:673,680); dropping the cfg kwargs here would give the
        # fallback different length/temperature than every other answer.
        fb_answers = runner_chat_batch(
            [build_general_messages(questions[i]) for i in fb],
            max_tokens=cfg.llm_max_tokens,
            temperature=cfg.llm_temperature, top_p=cfg.llm_top_p,
        )
        for i, a in zip(fb, fb_answers):
            answers[i] = a.strip()
            from_fallback[i] = True

    out_results = []
    for i in range(n):
        answer = answers[i]
        if cfg.translate_on_miss and _needs_translation(answer, langs[i]):
            answer = _translate_text(answer, langs[i], runner)
        sources_title = "Sources" if langs[i] == "en" else "Fonti"
        if strict and not from_fallback[i]:
            answer = enforce_citations(
                answer, provs[i],
                add_sources_block=add_sources, sources_title=sources_title,
            )
        out_results.append(AskResult(
            question=questions[i], answer=answer, language=langs[i],
            top_k=int(top_k),
            sources=[] if from_fallback[i] else provs[i],
            retrieved=results_list[i], filters_applied=where,
            hybrid=bool(hybrid),
        ))
    return out_results
