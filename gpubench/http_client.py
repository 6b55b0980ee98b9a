"""A small asyncio HTTP/1.1 client for streamed completions (SSE over
chunked transfer encoding), one connection a request, in the process and
thread of the load generator. Each served token is stamped with
``time.perf_counter()`` as its chunk is parsed."""

from __future__ import annotations

import asyncio
import json
import time


async def stream(host: str, port: int, path: str, body: dict, rec: dict):
    """POST `body` to `path` with ``"stream": true`` and fill `rec`:
    "status", "ids" (the served ids), "t_tokens" (one stamp each), "done"
    (the stream ended with [DONE]) or "error"."""
    rec.update(ids=[], t_tokens=[], done=False)
    writer = None
    try:
        reader, writer = await asyncio.open_connection(host, port)
        payload = json.dumps(dict(body, stream=True)).encode()
        writer.write(
            f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            "Accept: text/event-stream\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
            .encode() + payload)
        await writer.drain()
        status = await reader.readline()
        rec["status"] = int(status.split()[1])
        chunked = False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            if k.strip().lower() == "transfer-encoding" \
                    and "chunked" in v.lower():
                chunked = True
        if rec["status"] != 200:
            rec["error"] = f"HTTP {rec['status']}: " + (
                await reader.read(2000)).decode("utf-8", "replace")
            return
        buf = b""
        while True:
            if chunked:
                size = int((await reader.readline()).split(b";")[0], 16)
                if size == 0:
                    break
                data = await reader.readexactly(size + 2)
                buf += data[:-2]
            else:
                data = await reader.read(65536)
                if not data:
                    break
                buf += data
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if _event(event, rec):
                    return
        if not rec["done"]:
            rec["error"] = "stream ended before [DONE]"
    except (OSError, ValueError, asyncio.IncompleteReadError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        if writer is not None:
            writer.close()


def _event(event: bytes, rec: dict) -> bool:
    """One SSE event; True at [DONE]."""
    now = time.perf_counter()
    for line in event.split(b"\n"):
        if not line.startswith(b"data: "):
            continue
        data = line[6:].strip()
        if data == b"[DONE]":
            rec["done"] = True
            return True
        item = json.loads(data)
        if "error" in item:
            rec["error"] = str(item["error"])
            continue
        text = item["choices"][0].get("text", "")
        if text:
            rec["ids"].append(int(text))
            rec["t_tokens"].append(now)
    return False


def get_json(host: str, port: int, path: str, timeout: float = 60.0):
    """A plain GET (blocking; for a thread)."""
    import urllib.request

    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())
