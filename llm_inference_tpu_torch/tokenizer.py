"""Gemma tokenizer: vocab from GGUF metadata, greedy longest-match encode.

Token-for-token port of the reference's tokenizer semantics (reference
model.cpp:1051-1191): vocabulary and special-token ids from GGUF metadata
with the reference's fallbacks, hardcoded gemma3/gemma4 chat templates,
space -> U+2581 rewriting, and the greedy longest-match loop (deliberately
NOT true SentencePiece BPE — the reference approximates, and output parity
requires matching its approximation exactly, SURVEY.md §7 hard part d).

The scan uses a longest-match trie walk, O(n * max_token_len) worst case
like the reference but without its per-length substring hashing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

SPIECE_SPACE = "▁"  # ▁


@dataclasses.dataclass
class TokenizerResult:
    ids: list[int]
    prefilled_thinking: bool = False


class Tokenizer:
    def __init__(self, metadata: Mapping[str, Any], architecture: str):
        self.architecture = architecture
        self.id_to_token: list[str] = list(metadata["tokenizer.ggml.tokens"])
        self.token_to_id = {tok: i for i, tok in enumerate(self.id_to_token)}
        # The reference's longest-match loop walks UTF-8 BYTES of a
        # std::string (model.cpp:1148-1178): out-of-vocab multi-byte
        # characters emit one <unk> per byte and the scan may resynchronize
        # mid-codepoint. Match over bytes with a bytes-keyed vocab to
        # reproduce that exactly.
        self.btoken_to_id = {tok.encode("utf-8"): i for i, tok in enumerate(self.id_to_token)}

        # BOS/UNK/EOS resolution with the reference's fallback chain
        # (model.cpp:1064-1086, main.cpp:124-136).
        if "tokenizer.ggml.bos_token_id" in metadata:
            self.bos_id = int(metadata["tokenizer.ggml.bos_token_id"])
        elif "<bos>" in self.token_to_id:
            self.bos_id = self.token_to_id["<bos>"]
        elif len(self.token_to_id) > 2:
            self.bos_id = 2  # Gemma default
        else:
            self.bos_id = -1

        if "tokenizer.ggml.unk_token_id" in metadata:
            self.unk_id = int(metadata["tokenizer.ggml.unk_token_id"])
        else:
            self.unk_id = self.token_to_id.get("<unk>", -1)

        self.eos_id = int(metadata.get("tokenizer.ggml.eos_token_id", -1))
        self.add_bos = bool(metadata.get("tokenizer.ggml.add_bos_token", True))

        self.end_of_turn_id = -1
        for i, ts in enumerate(self.id_to_token):
            if ts in ("<end_of_turn>", "<turn|>"):
                self.end_of_turn_id = i
                break

        # Thinking-mode display tokens (reference main.cpp:138-156).
        self.think_id = -1
        self.channel_id = -1
        for i, ts in enumerate(self.id_to_token):
            if ts == "<|channel>thought":
                self.think_id = i
            elif ts in ("<|think|>", "<think>") and self.think_id == -1:
                self.think_id = i
            if ts == "<channel|>":
                self.channel_id = i
            elif ts in ("<|channel|>", "</think>") and self.channel_id == -1:
                self.channel_id = i

        # byte length, like the reference's std::string::length() bound
        self.max_token_len = max((len(t) for t in self.btoken_to_id), default=0)

    # -- encode ---------------------------------------------------------------

    def encode(self, prompt: str, apply_chat_template: bool = True) -> TokenizerResult:
        """Tokenize with the reference's template + greedy longest-match
        (model.cpp:1091-1191)."""
        ids: list[int] = []
        prefilled_thinking = False
        if apply_chat_template:
            if self.architecture == "gemma4":
                if self.add_bos and self.bos_id != -1:
                    ids.append(self.bos_id)
                text = f"<|turn>user\n{prompt}<turn|>\n<|turn>model\n<|channel>thought"
                prefilled_thinking = True
            else:
                if self.bos_id != -1:
                    ids.append(self.bos_id)
                text = f"<start_of_turn>user\n{prompt}<end_of_turn>\n<start_of_turn>model\n"
        else:
            if self.architecture == "gemma4":
                text = prompt
            else:
                if self.bos_id != -1:
                    ids.append(self.bos_id)
                text = " " + prompt

        data = text.replace(" ", SPIECE_SPACE).encode("utf-8")

        i, n = 0, len(data)
        vocab = self.btoken_to_id
        max_len = self.max_token_len
        while i < n:
            best_id = -1
            best_len = 0
            limit = min(max_len, n - i)
            for length in range(1, limit + 1):
                tid = vocab.get(data[i : i + length])
                if tid is not None:
                    best_id, best_len = tid, length
            if best_id != -1:
                ids.append(best_id)
                i += best_len
            else:
                if self.unk_id != -1:
                    ids.append(self.unk_id)
                i += 1
        return TokenizerResult(ids=ids, prefilled_thinking=prefilled_thinking)

    # -- decode ---------------------------------------------------------------

    def piece(self, token_id: int) -> str:
        """Display string of one token: ▁ -> space (reference main.cpp:16-25)."""
        return self.id_to_token[token_id].replace(SPIECE_SPACE, " ")

    def decode(self, ids: list[int]) -> str:
        return "".join(self.piece(i) for i in ids)

    def is_stop(self, token_id: int) -> bool:
        """Greedy-loop stop condition (reference main.cpp:196-198)."""
        return token_id == self.end_of_turn_id or token_id == self.eos_id
