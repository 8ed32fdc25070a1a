"""Ballot prompt text + forced-output schema.

Reference: src/score/completions/client.rs:533-572 (prompt injection) and
1291-1340 (ResponseKey::response_format).  The port's copy of
``llm_weighted_consensus_tpu/ballot/prompting.py``.
"""

from __future__ import annotations


def ballot_instruction(
    choices_string: str, keys: list, output_mode: str
) -> str:
    """System-message text presenting the ballot (client.rs:533-543).

    ``instruction`` mode must spell out the output contract; the forced
    modes (json_schema / tool_call) constrain the output mechanically.
    """
    if output_mode == "instruction":
        keys_list = "\n- ".join(keys)
        return (
            "Select the response:\n\n"
            f"{choices_string}\n\n"
            "Output exactly one response key including backticks, "
            "nothing else:\n"
            f"- {keys_list}"
        )
    return f"Select the response:\n\n{choices_string}"


def response_key_schema(keys: list, synthetic_reasoning: bool) -> dict:
    """Strict JSON schema forcing ``response_key`` (client.rs:1297-1340).

    With ``synthetic_reasoning`` a required ``_think`` field precedes the
    key, giving non-reasoning models a scratchpad inside the forced output.
    Used as ``response_format.json_schema.schema`` in json_schema mode and as
    forced-function parameters in tool_call mode.
    """
    properties: dict = {}
    required = []
    if synthetic_reasoning:
        properties["_think"] = {
            "type": "string",
            "description": "The assistant's internal reasoning.",
        }
        required.append("_think")
    properties["response_key"] = {"type": "string", "enum": list(keys)}
    required.append("response_key")
    return {
        "type": "object",
        "properties": properties,
        "required": required,
        "additionalProperties": False,
    }


def response_format_for(keys: list, synthetic_reasoning: bool) -> dict:
    """Full ``response_format`` body for json_schema output mode."""
    return {
        "type": "json_schema",
        "json_schema": {
            "name": "response_key",
            "strict": True,
            "schema": response_key_schema(keys, synthetic_reasoning),
        },
    }
