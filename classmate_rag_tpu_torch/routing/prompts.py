"""Per-route, per-language system prompts.

Structure parity with rag/routing/prompts.py:21-100: every grounded route
shares the citation contract (answer ONLY from the numbered context, cite
[n], reply exactly "I don't know" / "Non lo so" when the context lacks the
answer); the translation route skips it (that model only translates).

The prompt STRINGS are behavioral constants kept byte-equal to the
reference's (like the prototype seed phrases): the routed models were
tuned/selected against these exact contracts, and the unknown-answer
detector keys off the exact "I don't know"/"Non lo so" phrasing — the
reference differential fuzz enforces equality.

Host copy of the JAX package's ``routing/prompts.py`` (no JAX).
"""

from __future__ import annotations

from typing import Dict

from classmate_rag_tpu_torch.routing.types import Route

_CONTRACT_EN = (
    "Answer using ONLY the numbered context blocks provided by the user. "
    "Cite each statement with the matching [n] from the context. "
    "If the context does not contain the answer, reply exactly: I don't know."
)
_CONTRACT_IT = (
    "Rispondi UTILIZZANDO SOLO i blocchi di contesto numerati forniti dall'utente. "
    "Cita ogni affermazione con il [n] corrispondente. "
    "Se il contesto non contiene la risposta, rispondi esattamente: Non lo so."
)

_ROLE_EN: Dict[str, str] = {
    "math": "You are a mathematics tutor for university students. "
            "Solve problems step-by-step, show the work, and briefly justify each step.",
    "code": "You are a programming assistant. Provide correct, idiomatic code, "
            "explain key design choices, and note time/space complexity when relevant.",
    "default": "You are a study assistant for university students. "
               "Answer clearly and concisely, grounded in the provided sources.",
}
_ROLE_IT: Dict[str, str] = {
    "math": "Sei un tutor di matematica per studenti universitari. "
            "Risolvi problemi passo-passo, mostra i passaggi e giustifica brevemente.",
    "code": "Sei un assistente di programmazione. Fornisci codice corretto e idiomatico, "
            "spiega le scelte chiave e indica la complessità quando rilevante.",
    "default": "Sei un assistente di studio per studenti universitari. "
               "Rispondi in modo chiaro, ordinato e basato sulle fonti.",
}

# The translation model (SalamandraTA) is translation-only and ignores
# chat-style instructions: minimal direct prompt, NO citation contract.
_TRANSLATION_EN = (
    "You are a translator. Faithfully translate the user's text into the "
    "requested target language. Do not add commentary."
)
_TRANSLATION_IT = (
    "Sei un traduttore. Traduci fedelmente il testo dell'utente nella "
    "lingua di destinazione richiesta. Non aggiungere commenti."
)


def system_prompt_for(route: Route, language: str = "en") -> str:
    it = (language or "en").lower().startswith("it")
    if route == "translation":
        return _TRANSLATION_IT if it else _TRANSLATION_EN
    roles = _ROLE_IT if it else _ROLE_EN
    contract = _CONTRACT_IT if it else _CONTRACT_EN
    return f"{roles.get(route, roles['default'])}\n\n{contract}"
