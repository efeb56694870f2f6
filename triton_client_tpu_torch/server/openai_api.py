"""OpenAI-compatible routes over the generation stack.

The port's copy of ``triton_client_tpu/server/openai_api.py``:
``GET /v1/models``, ``POST /v1/completions`` and ``POST
/v1/chat/completions`` (streamed and not) on any model that speaks the
generate contract (decoupled, a ``text_input`` BYTES input, one response
per token: ``llama_generate``), so stock OpenAI SDKs or curl drive the
server unchanged:

    curl localhost:8000/v1/chat/completions -d '{
        "model": "llama_generate",
        "messages": [{"role": "user", "content": "hello"}],
        "max_tokens": 8, "stream": true}'

The parameters, their checks and texts, the stop scanner, ``n`` and
``best_of``, ``echo``, logprobs, usage (with ``device_time_us`` and
``prompt_tokens_details.cached_tokens`` where the server measured them) and
the SSE framing are the reference's.  The reference runs each choice as an
asyncio task over the core's async stream; the port's server is a thread
per connection and ``InferenceCore.infer_stream`` a plain generator that
runs the model on its calling thread.  So each choice runs on a thread of
its own and feeds one ``queue.Queue`` that the connection's thread drains;
a choice stops at a shared ``threading.Event`` (set by a sibling's
failure, or when the client goes away), checked between responses, and
closes its own generator, which frees its decode slot.  A stop sequence
closes the generator at once, on the choice's thread.

The HTTP frontend (``http_server.py``) owns the wire: :func:`completion`
returns a JSON body or an iterator of SSE frames whose first frame it
takes before it commits the 200.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from .core import InferenceCore
from .generate import sse_frame
from .qos import tenant_from_headers
from .types import InferError, InferRequest, InputTensor, RequestedOutput

_COUNTER = itertools.count(1)
_MAX_N = 16        # choices per request: each holds a decode slot
_MAX_STOPS = 4     # OpenAI: up to 4 stop sequences


def _parse_stop(stop) -> List[str]:
    """OpenAI ``stop``: a string or an array of up to 4 non-empty
    strings."""
    if stop is None or stop == []:  # an empty array: no stop
        return []
    if isinstance(stop, str):
        stop = [stop]
    if (not isinstance(stop, list) or not stop
            or not all(isinstance(s, str) and s for s in stop)):
        raise InferError(
            "'stop' must be a non-empty string or an array of non-empty "
            "strings")
    if len(stop) > _MAX_STOPS:
        raise InferError(f"'stop' supports at most {_MAX_STOPS} sequences")
    return stop


class _StopScanner:
    """Streams text through stop-sequence matching.

    ``feed(piece, lp)`` returns ``(text, lps)``: the text now safe to emit
    and the per-character logprob records that ride with it.  The last
    ``max(len(stop)) - 1`` characters are held back, so a delta never
    carries (a prefix of) a stop sequence that a later token completes.
    A piece's logprob rides on its first character (the byte models emit
    one character per token, so the records align with the text).  On a
    match the text before it is released, the stop text is swallowed and
    ``stopped`` latches.  ``tokens`` counts every token consumed, those of
    the stop sequence too: what ``usage.completion_tokens`` reports.
    """

    def __init__(self, stops: List[str]) -> None:
        self._stops = stops
        self._hold = max((len(s) for s in stops), default=1) - 1
        self._buf = ""
        self._lps: List[Optional[float]] = []  # per character of _buf
        self.stopped = False
        self.tokens = 0

    def feed(self, piece: str, lp: Optional[float] = None):
        self.tokens += 1
        piece_lps = ([lp] + [None] * (len(piece) - 1)) if piece else []
        if not self._stops:
            return piece, piece_lps
        self._buf += piece
        self._lps += piece_lps
        first = -1
        for s in self._stops:
            i = self._buf.find(s)
            if i >= 0 and (first < 0 or i < first):
                first = i
        if first >= 0:
            out, lps = self._buf[:first], self._lps[:first]
            self._buf, self._lps = "", []
            self.stopped = True
            return out, lps
        if len(self._buf) > self._hold:
            cut = len(self._buf) - self._hold
            out, lps = self._buf[:cut], self._lps[:cut]
            self._buf, self._lps = self._buf[cut:], self._lps[cut:]
            return out, lps
        return "", []

    def flush(self):
        """The generation's natural end: the held-back tail is output."""
        out, lps = self._buf, self._lps
        self._buf, self._lps = "", []
        return out, lps


def _generate_capable(model) -> bool:
    inputs = {i.name for i in model.config.input}
    return model.decoupled and "text_input" in inputs


def models_body(core: InferenceCore) -> dict:
    """``GET /v1/models``: the ready models that speak generate."""
    data = [{"id": m.name, "object": "model", "owned_by": "triton_client_tpu"}
            for m in core.registry.ready_models() if _generate_capable(m)]
    return {"object": "list", "data": data}


def _content_text(content) -> str:
    """A message's text: a string, or the content-parts array's text parts
    joined; anything else is a client error."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for p in content:
            if not isinstance(p, dict) or p.get("type") != "text" \
                    or not isinstance(p.get("text"), str):
                raise InferError("only text content parts are supported")
            parts.append(p["text"])
        return "".join(parts)
    raise InferError(
        "message 'content' must be a string or an array of text parts")


def _prompt_from_messages(messages: List[Dict[str, Any]]) -> str:
    """The minimal chat template: 'role: content' lines and the assistant
    cue (the byte-level models have no template of their own)."""
    if not isinstance(messages, list) or not messages:
        raise InferError("'messages' must be a non-empty array")
    lines = []
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise InferError("each message needs 'role' and 'content'")
        lines.append(f"{m.get('role', 'user')}: {_content_text(m['content'])}")
    lines.append("assistant:")
    return "\n".join(lines)


#: recognised parameters that are not supported, refused by endpoint: a
#: knob ignored in silence would answer 200s that look honoured
_REJECT_ALWAYS = {
    "logit_bias": "'logit_bias' is not supported",
}
_REJECT_COMPLETIONS = {
    "suffix": "'suffix' (insertion mode) is not supported",
}
_REJECT_CHAT = {
    "top_logprobs": "'top_logprobs' is not supported; 'logprobs' returns "
                    "the chosen token's logprob",
    "response_format": "'response_format' is not supported",
    "tools": "'tools' is not supported",
    "tool_choice": "'tool_choice' is not supported",
    "functions": "'functions' is not supported",
    "function_call": "'function_call' is not supported",
    "parallel_tool_calls": "'parallel_tool_calls' is not supported",
    "store": "'store' is not supported (completions are not persisted)",
    "metadata": "'metadata' is not supported (nothing is stored to attach "
                "it to)",
    "service_tier": "'service_tier' is not supported",
    "prediction": "'prediction' (predicted outputs) is not supported",
    "audio": "'audio' output is not supported",
    "modalities": "'modalities' is not supported (text only)",
    "reasoning_effort": "'reasoning_effort' is not supported",
    "best_of": "'best_of' is a completions parameter, not chat",
    "echo": "'echo' is a completions parameter, not chat",
    "suffix": "'suffix' is a completions parameter, not chat",
}


def _parse_stream_options(body: Dict[str, Any]) -> bool:
    """``stream_options``: ``{"include_usage": bool}`` is honoured (a final
    usage chunk with empty choices before [DONE], ``usage: null`` on the
    data chunks); anything else in it is refused."""
    opts = body.get("stream_options")
    if opts is None:
        return False
    if not isinstance(opts, dict):
        raise InferError("'stream_options' must be an object")
    if not body.get("stream"):
        raise InferError("'stream_options' requires 'stream': true")
    unknown = set(opts) - {"include_usage"}
    if unknown:
        raise InferError(
            f"unsupported stream_options key(s): {sorted(unknown)}")
    include = opts.get("include_usage", False)
    if not isinstance(include, bool):
        raise InferError("'stream_options.include_usage' must be a boolean")
    return include


class _ParsedRequest(NamedTuple):
    model_name: str
    reqs: List[InferRequest]
    stops: List[str]
    want_logprobs: bool
    n: int
    best_of: int
    echo: bool
    include_usage: bool


def _build_request(core: InferenceCore, body: Dict[str, Any], prompt: str,
                   chat: bool) -> _ParsedRequest:
    model_name = body.get("model")
    if not model_name:
        raise InferError("'model' is required")
    model = core.registry.get(model_name)
    if not _generate_capable(model):
        raise InferError(
            f"model '{model_name}' does not speak the generate contract "
            "(decoupled, text_input)")
    rejects = dict(_REJECT_ALWAYS)
    rejects.update(_REJECT_CHAT if chat else _REJECT_COMPLETIONS)
    for key, msg in rejects.items():
        if body.get(key):
            raise InferError(msg)
    n = body.get("n")
    if n is None:
        n = 1
    if not isinstance(n, int) or isinstance(n, bool) or not 1 <= n <= _MAX_N:
        raise InferError(f"'n' must be an integer in [1, {_MAX_N}]")
    stops = _parse_stop(body.get("stop"))
    # chosen-token logprobs; alternatives are refused in both spellings
    raw_lp = body.get("logprobs")
    if raw_lp is None or raw_lp is False:
        want_logprobs = False
    elif raw_lp is True or raw_lp == 0:
        want_logprobs = True  # completions logprobs: 0 = the chosen token
    elif isinstance(raw_lp, int):
        raise InferError(
            "'logprobs' alternatives (logprobs >= 1) are not supported; "
            "use logprobs: true (or 0) for chosen-token logprobs")
    else:
        raise InferError("'logprobs' must be a boolean or integer")
    best_of = body.get("best_of")
    if best_of is None:
        best_of = n
    if (not isinstance(best_of, int) or isinstance(best_of, bool)
            or not n <= best_of <= _MAX_N):
        raise InferError(
            f"'best_of' must be an integer in [n, {_MAX_N}] (got "
            f"{best_of!r}, n={n})")
    if best_of > n and body.get("stream"):
        raise InferError("'best_of' > n cannot be streamed (candidates "
                         "must complete before ranking)")
    echo = bool(body.get("echo", False))
    if echo and want_logprobs:
        raise InferError(
            "'echo' with 'logprobs' is not supported (prompt-token "
            "logprobs are not computed)")
    # the QoS priority (beyond OpenAI, like top_k): 0 is the highest
    priority = body.get("priority", 0)
    if (not isinstance(priority, int) or isinstance(priority, bool)
            or priority < 0):
        raise InferError("'priority' must be a non-negative integer")
    parameters: Dict[str, Any] = {}
    try:
        max_tokens = body.get("max_tokens")
        if max_tokens is None and chat:
            # chat's newer spelling of the same knob
            max_tokens = body.get("max_completion_tokens")
        if max_tokens is not None:
            parameters["max_tokens"] = int(max_tokens)
        if body.get("temperature") is not None:
            parameters["temperature"] = float(body["temperature"])
        if body.get("seed") is not None:
            parameters["seed"] = int(body["seed"])
        if body.get("top_p") is not None:
            parameters["top_p"] = float(body["top_p"])
            if body.get("temperature") is None:
                # OpenAI samples at temperature 1 by default: top_p alone
                # must not fall back to the generate contract's greedy
                parameters["temperature"] = 1.0
        if body.get("top_k") is not None:  # beyond OpenAI
            parameters["top_k"] = int(body["top_k"])
        for pen in ("frequency_penalty", "presence_penalty"):
            if body.get(pen) is not None:
                parameters[pen] = float(body[pen])
                if not -2.0 <= parameters[pen] <= 2.0:
                    raise ValueError(f"'{pen}' must be in [-2, 2]")
    except (TypeError, ValueError) as e:
        raise InferError(f"invalid sampling parameter: {e}")
    reqs = []
    for i in range(best_of):
        p = dict(parameters)
        if "seed" in p and best_of > 1:
            # a fixed seed still gives distinct candidates, reproducibly
            p["seed"] = p["seed"] + i
        outputs = [RequestedOutput(name="text_output", binary_data=False)]
        if want_logprobs or best_of > n:
            # best_of ranks by mean token logprob: the stream carries them
            outputs.append(RequestedOutput(name="logprob", binary_data=False))
        reqs.append(InferRequest(
            model_name=model_name,
            inputs=[InputTensor(
                name="text_input", datatype="BYTES", shape=(1,),
                data=np.asarray([prompt.encode()], dtype=object))],
            outputs=outputs, parameters=p, priority=priority))
    return _ParsedRequest(model_name, reqs, stops, want_logprobs, n,
                          best_of, echo, _parse_stream_options(body))


def _choice(index: int, kind: str, delta_or_text: Optional[str],
            finish: Optional[str], chat: bool) -> dict:
    if chat:
        entry: Dict[str, Any] = {"index": index, "finish_reason": finish}
        entry["delta" if kind == "chunk" else "message"] = (
            {} if delta_or_text is None
            else ({"content": delta_or_text} if kind == "chunk"
                  else {"role": "assistant", "content": delta_or_text}))
    else:
        entry = {"index": index, "text": delta_or_text or "",
                 "finish_reason": finish}
    return entry


def _envelope(rid: str, created: int, model: str, kind: str, chat: bool,
              choices: List[dict]) -> dict:
    if chat:
        obj = "chat.completion.chunk" if kind == "chunk" else "chat.completion"
    else:
        obj = "text_completion"
    return {"id": rid, "object": obj, "created": created, "model": model,
            "choices": choices}


def _lp_payload(records, chat: bool):
    """OpenAI's logprobs structure of ``[(char, lp, text_offset)]``."""
    if chat:
        # the whole ChatCompletionTokenLogprob shape, for strict parsers
        return {"content": [
            {"token": ch, "logprob": lp,
             "bytes": list(ch.encode()), "top_logprobs": []}
            for ch, lp, _off in records]}
    return {
        "tokens": [ch for ch, _lp, _off in records],
        "token_logprobs": [lp for _ch, lp, _off in records],
        "top_logprobs": None,
        "text_offset": [off for _ch, _lp, off in records],
    }


class _Choices:
    """Every choice of one request, each on a thread of its own, feeding
    one queue with ``(index, kind, payload)`` items: ``"delta"`` (text and
    its ``(char, lp, offset)`` records), ``"finish"`` (reason, tokens,
    device microseconds or None, prefix-cache hit tokens) or ``"error"``.
    :meth:`close` asks every choice to stop and waits for them: each
    closes its own stream, which frees its decode slot."""

    def __init__(self, core: InferenceCore, pr: _ParsedRequest,
                 prompt: str):
        self._core = core
        self._pr = pr
        self._prompt = prompt
        self.q: "queue.Queue" = queue.Queue()
        self.cancel = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, args=(i, req), daemon=True,
                             name=f"oai-choice-{i}")
            for i, req in enumerate(pr.reqs)]
        for t in self._threads:
            t.start()

    def _run(self, i: int, req: InferRequest) -> None:
        pr, prompt, q = self._pr, self._prompt, self.q
        scanner = _StopScanner(pr.stops)
        sent = [len(prompt) if pr.echo else 0]
        # echo's prompt leads the choice's frames, but only once the first
        # token came: the frontend takes the first frame before the 200, so
        # a refusal before generation (429, no free slot) keeps its status
        pending_echo = [pr.echo]

        def put_echo():
            if pending_echo[0]:
                pending_echo[0] = False
                q.put((i, "delta", (prompt, [])))

        def emit(text, lps):
            put_echo()
            base = sent[0]
            sent[0] += len(text)
            q.put((i, "delta", (text, [
                (ch, lp, base + k) for k, (ch, lp) in enumerate(zip(text,
                                                                   lps))
                if lp is not None])))

        cost: Dict[str, float] = {}
        try:
            finish = self._consume(req, scanner, emit, cost)
            if finish is None:
                return  # cancelled: nobody reads on
            put_echo()  # a generation with no delta still echoes
            q.put((i, "finish", (finish, scanner.tokens,
                                 cost.get("device_time_us"),
                                 cost.get("cache_hit_tokens", 0))))
        except Exception as e:  # noqa: BLE001 - raised by the reader
            q.put((i, "error", e))

    def _consume(self, req: InferRequest, scanner: _StopScanner, emit,
                 cost: Dict[str, float]) -> Optional[str]:
        """One stream through the stop scanner: the finish reason, or None
        where the choice was cancelled.  Its generator is closed here, on
        this thread, on every exit: a stop or a cancel frees the slot
        before the next token."""
        stream = self._core.infer_stream(req)
        try:
            for resp in stream:
                if self.cancel.is_set():
                    return None
                params = resp.parameters or {}
                dev = params.get("device_time_us")
                if dev is not None:
                    cost["device_time_us"] = (
                        cost.get("device_time_us", 0.0) + float(dev))
                hit = params.get("cache_hit_tokens")
                if hit is not None:
                    # the prompt tokens served from cached KV blocks:
                    # usage's prompt_tokens_details.cached_tokens
                    cost["cache_hit_tokens"] = (
                        cost.get("cache_hit_tokens", 0) + int(hit))
                texts = lps = None
                for t in resp.outputs:
                    if t.data is None:
                        continue
                    if t.name == "text_output":
                        texts = np.asarray(t.data).reshape(-1)
                    elif t.name == "logprob":
                        lps = np.asarray(t.data).reshape(-1)
                if texts is None:
                    continue
                for j, v in enumerate(texts):
                    piece = (v.decode("utf-8", "replace")
                             if isinstance(v, bytes) else str(v))
                    lp = (float(lps[j])
                          if lps is not None and j < len(lps) else None)
                    out, out_lps = scanner.feed(piece, lp)
                    if out:
                        emit(out, out_lps)
                    if scanner.stopped:
                        return "stop"
            tail, tail_lps = scanner.flush()
            if tail:
                emit(tail, tail_lps)
            return "length"
        finally:
            stream.close()

    def items(self) -> Iterator[Tuple[int, str, Any]]:
        """The choices' items until each finished; a choice's error is
        raised (an InferError as it is, anything else as a 500)."""
        open_choices = len(self._threads)
        while open_choices:
            i, kind, payload = self.q.get()
            if kind == "error":
                raise payload if isinstance(payload, InferError) \
                    else InferError(str(payload), 500)
            if kind == "finish":
                open_choices -= 1
            yield i, kind, payload

    def close(self) -> None:
        self.cancel.set()
        for t in self._threads:
            t.join()


def _read_json(raw: bytes) -> dict:
    try:
        body = json.loads(raw)
    except ValueError:
        raise InferError("failed to parse request JSON")
    if not isinstance(body, dict):
        raise InferError("request body must be a JSON object")
    return body


def completion(core: InferenceCore, raw: bytes, headers, chat: bool
               ) -> Tuple[Optional[dict], Optional[Iterator[bytes]]]:
    """One ``/v1/completions`` or ``/v1/chat/completions`` request:
    ``(body, None)`` where it is not streamed, else ``(None, frames)``, an
    iterator of SSE frames whose first item the caller takes before it
    commits the 200, and closes when it stops early."""
    body = _read_json(raw)
    if chat:
        prompt = _prompt_from_messages(body.get("messages"))
    else:
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str):
            raise InferError("'prompt' must be a string")
    pr = _build_request(core, body, prompt, chat)
    # the QoS identity the v2 routes resolve from the same headers
    tenant = tenant_from_headers(headers.get("triton-tenant"),
                                 headers.get("Authorization"))
    for req in pr.reqs:
        req.tenant = tenant
    rid = f"cmpl-{next(_COUNTER)}"
    created = int(time.time())
    if not body.get("stream", False):
        return _whole(core, pr, prompt, chat, rid, created), None
    return None, _streamed(core, pr, prompt, chat, rid, created)


def _usage(prompt: str, completion_tokens: int, device_us: Optional[float],
           cached_tokens: int) -> dict:
    p_toks = len(prompt.encode())
    usage: Dict[str, Any] = {
        "prompt_tokens": p_toks,
        "completion_tokens": completion_tokens,
        "total_tokens": p_toks + completion_tokens,
    }
    if device_us is not None:
        usage["device_time_us"] = round(device_us, 1)
    if cached_tokens:
        # OpenAI's prompt-caching shape: prompt tokens whose KV came from
        # the prefix cache (left out when none did)
        usage["prompt_tokens_details"] = {"cached_tokens": cached_tokens}
    return usage


def _whole(core, pr: _ParsedRequest, prompt: str, chat: bool, rid: str,
           created: int) -> dict:
    """Every choice run to its end (the first failure cancels the rest),
    ranked where ``best_of > n``."""
    texts: List[List[str]] = [[] for _ in pr.reqs]
    records: List[List[tuple]] = [[] for _ in pr.reqs]
    finished: Dict[int, tuple] = {}
    choices = _Choices(core, pr, prompt)
    try:
        for i, kind, payload in choices.items():
            if kind == "delta":
                text, recs = payload
                texts[i].append(text)
                records[i].extend(recs)
            else:
                finished[i] = payload
    finally:
        choices.close()
    # with echo the prompt came first as its own delta
    results = [("".join(texts[i]), finished[i], records[i])
               for i in range(len(pr.reqs))]
    completion_tokens = sum(r[1][1] for r in results)
    device_us = [r[1][2] for r in results if r[1][2] is not None]
    cached_tokens = sum(r[1][3] for r in results)
    if pr.best_of > pr.n:
        # rank by mean chosen-token logprob and keep the n best; usage
        # still counts every candidate
        def mean_lp(res):
            recs = res[2]
            return (sum(lp for _c, lp, _o in recs) / len(recs)
                    if recs else float("-inf"))

        results = sorted(results, key=mean_lp, reverse=True)[:pr.n]
    out_choices = []
    for i, (text, fin, recs) in enumerate(results):
        entry = _choice(i, "full", text, fin[0], chat)
        if pr.want_logprobs:
            entry["logprobs"] = _lp_payload(recs, chat)
        out_choices.append(entry)
    out = _envelope(rid, created, pr.model_name, "full", chat, out_choices)
    out["usage"] = _usage(prompt, completion_tokens,
                          sum(device_us) if device_us else None,
                          cached_tokens)
    return out


def _streamed(core, pr: _ParsedRequest, prompt: str, chat: bool, rid: str,
              created: int) -> Iterator[bytes]:
    """The SSE frames: the choices' deltas interleaved, each tagged with
    its index, each choice's finish_reason chunk, the usage chunk where
    asked for, then ``[DONE]``.  A choice's error is raised from here."""
    completion_total = 0
    device_total, measured = 0.0, False
    cached_total = 0
    choices = _Choices(core, pr, prompt)
    try:
        for i, kind, payload in choices.items():
            if kind == "delta":
                text, recs = payload
                entry = _choice(i, "chunk", text, None, chat)
                if pr.want_logprobs:
                    entry["logprobs"] = _lp_payload(recs, chat)
            else:
                completion_total += payload[1]
                if payload[2] is not None:
                    device_total += payload[2]
                    measured = True
                cached_total += payload[3]
                entry = _choice(i, "chunk", None, payload[0], chat)
            frame = _envelope(rid, created, pr.model_name, "chunk", chat,
                              [entry])
            if pr.include_usage:
                # data chunks carry usage: null, the last chunk the totals
                frame["usage"] = None
            yield sse_frame(json.dumps(frame))
    finally:
        choices.close()
    if pr.include_usage:
        frame = _envelope(rid, created, pr.model_name, "chunk", chat, [])
        frame["usage"] = _usage(prompt, completion_total,
                                device_total if measured else None,
                                cached_total)
        yield sse_frame(json.dumps(frame))
    yield sse_frame("[DONE]")


def error_frame(e: Exception) -> bytes:
    """A failure after the headers, in band."""
    return sse_frame(json.dumps({"error": {
        "message": str(e), "type": "invalid_request_error"}}))


def error_body(e: Exception) -> Tuple[int, dict]:
    """OpenAI's error shape, ``{"error": {"message", "type"}}`` (the v2
    routes' is flat)."""
    if isinstance(e, InferError):
        return e.http_status, {"error": {
            "message": str(e), "type": "invalid_request_error"}}
    return 500, {"error": {"message": str(e), "type": "internal_error"}}


__all__ = ["completion", "error_body", "error_frame", "models_body"]
