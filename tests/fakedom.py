"""Headless DOM + synchronous fetch bridge for booting the viewer's app.js
inside the ES-subset interpreter (tests/jsinterp.py) against a REAL
EngineSession — the last viewer layer that had never executed anywhere
(no browser/node exists in this image).

Model: DOM nodes are plain dicts of values + Python callables (the
interpreter calls dict members natively); `children` lists are live;
index.html is parsed with the stdlib html.parser into the same node shape,
so `#row-template` clones produce real row structures.  `fetch` dispatches
synchronously into the service's command registry (the same COMMANDS /
AXIS_COMMANDS / MISC_COMMANDS tables aiohttp uses), so every api.js call
the app makes runs the actual engine.  Timers and animation frames are
collected on a manual clock the test steps deterministically.
"""

from __future__ import annotations

import json as _json
import pathlib
from html.parser import HTMLParser

from tests.jsinterp import UNDEF, JSArrayBuffer, js_to_string


def to_js_json(v):
    """JSON -> interpreter value model (every number is a float)."""
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, list):
        return [to_js_json(x) for x in v]
    if isinstance(v, dict):
        return {k: to_js_json(x) for k, x in v.items()}
    return v

# ---------------------------------------------------------------------------
# DOM nodes


def _classlist(el):
    classes = el["_classes"]

    def toggle(name, force=UNDEF):
        if force is UNDEF:
            if name in classes:
                classes.discard(name)
            else:
                classes.add(name)
        elif force:
            classes.add(name)
        else:
            classes.discard(name)

    return {
        "add": lambda *ns: classes.update(ns),
        "remove": lambda *ns: [classes.discard(n) for n in ns] and None,
        "toggle": toggle,
        "contains": lambda n: n in classes,
    }


def _matches(el, selector):
    s = selector.strip()
    if s.startswith("#"):
        return el.get("id") == s[1:]
    if s.startswith("."):
        # dynamically-created nodes set .className as a plain property (no
        # setter hook exists on dict-backed elements) — honor both stores
        return (
            s[1:] in el["_classes"]
            or s[1:] in str(el.get("className", "")).split()
        )
    if s.startswith("["):
        # [data-id-ch="..."] — the one attribute form the viewer uses
        inner = s[1:-1]
        key, _, val = inner.partition("=")
        val = val.strip('"')
        if key.startswith("data-"):
            prop = "".join(
                w.capitalize() if i else w
                for i, w in enumerate(key[5:].split("-"))
            )
            return js_to_string(el["dataset"].get(prop, UNDEF)) == val
        return False
    return el.get("tagName") == s.upper()


def _walk(el):
    for c in list(el["children"]):
        yield c
        yield from _walk(c)


def make_element(doc, tag, attrs=None):
    el = {}
    el["tagName"] = tag.upper()
    el["_classes"] = set()
    el["children"] = []
    el["dataset"] = {}
    el["style"] = {}
    style = el["style"]
    style["setProperty"] = lambda k, v: style.__setitem__(k, v)
    style["getPropertyValue"] = lambda k: style.get(k, "")
    el["textContent"] = ""
    el["value"] = ""
    el["hidden"] = False
    el["disabled"] = False
    el["_handlers"] = {}
    el["_parent"] = None
    el["_doc"] = doc
    for k, v in (attrs or []):
        if k == "class":
            el["_classes"].update((v or "").split())
        elif k == "id":
            el["id"] = v
        elif k == "value":
            el["value"] = v
        elif k == "hidden":
            el["hidden"] = True
        elif k == "disabled":
            el["disabled"] = True
        elif k in ("min", "max", "step"):
            el[k] = v  # numeric-input bounds (FloatRangeInput clamps)
        elif k and k.startswith("data-"):
            prop = "".join(
                w.capitalize() if i else w for i, w in enumerate(k[5:].split("-"))
            )
            el["dataset"][prop] = v
    el["classList"] = _classlist(el)

    def add_listener(name, fn, _opts=UNDEF):
        el["_handlers"].setdefault(name, []).append(fn)

    def query(selector):
        for c in _walk(el):
            if _matches(c, selector):
                return c
        return None

    def append_child(child):
        if child["_parent"] is not None:
            child["_parent"]["children"].remove(child)
        child["_parent"] = el
        el["children"].append(child)
        return child

    def insert_before(child, anchor=None):
        if child["_parent"] is not None:
            child["_parent"]["children"].remove(child)
        child["_parent"] = el
        if anchor in (None, UNDEF):
            el["children"].append(child)
        else:
            el["children"].insert(el["children"].index(anchor), child)
        return child

    def remove():
        if el["_parent"] is not None:
            el["_parent"]["children"].remove(el)
            el["_parent"] = None

    def closest(selector):
        cur = el
        while cur is not None:
            if _matches(cur, selector):
                return cur
            cur = cur["_parent"]
        return None

    def get_rect():
        # synthetic layout: each .track-row band is 160 px tall; every
        # element inside a row shares the row's band (enough for culling,
        # hit tests and the interaction math)
        top = 0.0
        anchor = el
        while anchor is not None and "track-row" not in anchor["_classes"]:
            anchor = anchor["_parent"]
        if anchor is not None and anchor["_parent"] is not None:
            kids = anchor["_parent"]["children"]
            if anchor in kids:
                top = 160.0 * kids.index(anchor)
        return {
            "left": 0.0, "top": top, "right": 1000.0, "bottom": top + 160.0,
            "width": 1000.0, "height": 160.0, "x": 0.0, "y": top,
        }

    def clone_node(deep=True):
        c = make_element(doc, el["tagName"])
        c["_classes"] = set(el["_classes"])
        c["classList"] = _classlist(c)
        if "id" in el:
            c["id"] = el["id"]
        c["dataset"] = dict(el["dataset"])
        c["textContent"] = el["textContent"]
        c["value"] = el["value"]
        # template inputs carry clamping/visibility attributes the cloned
        # rows must keep (parseFloat(rangeEl.min) silently NaN'd without
        # them — review finding)
        for attr in ("min", "max", "step", "hidden", "disabled", "type",
                     "title", "placeholder"):
            if attr in el:
                c[attr] = el[attr]
        if deep:
            for ch in el["children"]:
                append = c["appendChild"]
                append(ch["cloneNode"](True))
        c["firstElementChild"] = c["children"][0] if c["children"] else None
        return c

    def get_context(_kind, _opts=UNDEF):
        return el.setdefault("_ctx", make_canvas_ctx())

    def focus():
        # `doc` here is the FakeBrowser; the document node lives at .doc
        docdict = getattr(doc, "doc", None)
        if isinstance(docdict, dict):
            docdict["activeElement"] = el
        # fire the onfocus PROPERTY too, like blur() fires onblur — app.js
        # assigns textEl.onfocus to capture pre-edit values (review finding)
        onfocus = el.get("onfocus")
        if callable(onfocus):
            onfocus({"target": el})
        for fn in el["_handlers"].get("focus", []):
            fn({"target": el})

    def blur():
        docdict = getattr(doc, "doc", None)
        if isinstance(docdict, dict) and docdict.get("activeElement") is el:
            docdict["activeElement"] = None
        for fn in el["_handlers"].get("blur", []):
            fn({"target": el})
        handler = el.get("onblur")
        if callable(handler):
            handler({"target": el})

    el["addEventListener"] = add_listener
    el["removeEventListener"] = lambda name, fn, _o=UNDEF: None
    el["querySelector"] = query
    el["appendChild"] = append_child
    el["insertBefore"] = insert_before
    el["remove"] = remove
    el["closest"] = closest
    el["getBoundingClientRect"] = get_rect
    el["cloneNode"] = clone_node
    el["getContext"] = get_context
    el["focus"] = focus
    el["blur"] = blur
    el["select"] = lambda: None
    el["click"] = lambda: None
    el["contains"] = lambda other: other is el or any(c is other for c in _walk(el))
    el["setAttribute"] = lambda k, v: None
    el["clientWidth"] = 1000.0
    el["clientHeight"] = 160.0
    el["offsetTop"] = 0.0
    el["offsetLeft"] = 0.0
    el["scrollTop"] = 0.0
    el["width"] = 0.0
    el["height"] = 0.0
    el["firstElementChild"] = None
    return el


_CTX_STYLE_KEYS = {
    "fillStyle", "strokeStyle", "globalAlpha", "font", "textAlign",
    "textBaseline", "lineWidth",
}


class _RecordingCtx(dict):
    """Records style-property assignments as ("set:<name>", value) ops so
    tests can assert e.g. that the limiter band used its gain color."""

    def __setitem__(self, key, value):
        if key in _CTX_STYLE_KEYS:
            self["_ops"].append((f"set:{key}", value))
        super().__setitem__(key, value)


def make_canvas_ctx():
    """2D context that records draw calls (ops list) and accepts state."""
    ctx = _RecordingCtx()
    dict.__setitem__(ctx, "_ops", [])

    def op(name):
        def fn(*args):
            ctx["_ops"].append((name, args))
            if name == "measureText":
                return {"width": float(6 * len(args[0]) if args else 0)}
        return fn

    for name in (
        "setTransform", "clearRect", "fillRect", "strokeRect", "beginPath",
        "moveTo", "lineTo", "stroke", "fill", "closePath", "drawImage",
        "clip", "translate", "save", "restore", "scale", "rect",
        "setLineDash", "fillText", "measureText", "arc", "roundRect",
        "putImageData", "createImageData",
    ):
        ctx[name] = op(name)
    return ctx


class _HtmlBuilder(HTMLParser):
    VOID = {"input", "br", "img", "meta", "link", "hr"}

    def __init__(self, doc):
        super().__init__()
        self.doc = doc
        self.root = make_element(doc, "html")
        self.stack = [self.root]

    def handle_starttag(self, tag, attrs):
        el = make_element(self.doc, tag, attrs)
        self.stack[-1]["appendChild"](el)
        if tag == "template":
            # template content is a separate fragment (cloneNode target)
            content = make_element(self.doc, "#content")
            el["content"] = content
            self.stack.append(content)
        elif tag not in self.VOID:
            self.stack.append(el)

    def handle_endtag(self, tag):
        if tag in self.VOID:
            return
        if len(self.stack) > 1:
            self.stack.pop()

    def handle_data(self, data):
        if data.strip() and self.stack:
            kids = self.stack[-1]["children"]
            target = kids[-1] if False else self.stack[-1]
            target["textContent"] = (target["textContent"] or "") + data.strip()


# ---------------------------------------------------------------------------
# document / window / timers / fetch


class FakeBrowser:
    """All the globals app.js touches, plus a manual clock."""

    def __init__(self, session, index_html: str, media_paths=None):
        from thesia_tpu.engine.dispatch import Dispatcher, _jsonable

        self.session = session
        self.dispatcher = Dispatcher(session)
        self._jsonable = _jsonable
        self.media_paths = [str(p) for p in (media_paths or [])]
        self.now_ms = 0.0
        self.timers = []  # (due_ms, seq, fn) one-shot
        self.raf = []  # pending animation frame callbacks
        self._seq = 0
        self.doc = self._build_document(index_html)
        self.local_storage = {}
        self.fetch_log = []  # every fetched URL, in order (tests inspect)
        self.audio_contexts = []  # fake AudioContexts (clock-synced dicts)

    # -- DOM ----------------------------------------------------------------
    def _build_document(self, index_html):
        b = _HtmlBuilder(self)
        b.feed(index_html)
        root = b.root
        doc = make_element(self, "#document")
        doc["appendChild"](root)
        body = None
        for el in _walk(doc):
            if el["tagName"] == "BODY":
                body = el
        doc["body"] = body or root
        doc["documentElement"] = root

        def query(sel):
            for el in _walk(doc):
                if _matches(el, sel):
                    return el
            return None

        def create(tag):
            return make_element(self, tag)

        doc["querySelector"] = query
        doc["createElement"] = create
        return doc

    # -- timers -------------------------------------------------------------
    def set_timeout(self, fn, delay=0.0, *args):
        self._seq += 1
        handle = float(self._seq)
        self.timers.append((self.now_ms + float(delay or 0), handle, fn, args))
        return handle

    def clear_timer(self, handle=UNDEF):
        self.timers = [t for t in self.timers if t[1] != handle]

    def request_frame(self, fn):
        self.raf.append(fn)
        self._seq += 1
        return float(self._seq)

    def step_frames(self, n=1):
        """Run n animation frames (renderFrame re-schedules itself)."""
        for _ in range(n):
            pending, self.raf = self.raf, []
            for fn in pending:
                fn(self.now_ms)

    def advance(self, ms):
        """Advance the manual clock, firing due timers in order."""
        target = self.now_ms + ms
        while True:
            due = sorted(
                (t for t in self.timers if t[0] <= target), key=lambda t: (t[0], t[1])
            )
            if not due:
                break
            t0, handle, fn, args = due[0]
            self.timers = [t for t in self.timers if t[1] != handle]
            self.now_ms = max(self.now_ms, t0)
            self._sync_audio_clocks()
            fn(*args)
        self.now_ms = target
        self._sync_audio_clocks()

    # -- fake Web Audio -------------------------------------------------------
    def _sync_audio_clocks(self):
        for ctx in self.audio_contexts:
            ctx["currentTime"] = max(0.0, (self.now_ms - ctx["_created_ms"]) / 1000.0)

    def make_audio_context(self, sample_rate=48000.0):
        """Fake AudioContext: manual-clock currentTime, createBuffer /
        createBufferSource recording every scheduled (startTime, lanes)
        chunk in ctx["_scheduled"] for byte-level assertions."""
        ctx = {
            "sampleRate": float(sample_rate),
            "currentTime": 0.0,
            "_created_ms": self.now_ms,
            "state": "running",
            "destination": {"_sink": True},
            "_scheduled": [],  # dicts: startTime, lanes, stoppedAt
        }

        def create_buffer(channels, frames, sr):
            return {
                "numberOfChannels": float(channels),
                "length": float(frames),
                "sampleRate": float(sr),
                "_lanes": {},
                "copyToChannel": UNDEF,  # bound below (needs the dict)
            }

        def make_source():
            src = {"buffer": None, "onended": None, "_connected": None}

            def connect(dest):
                src["_connected"] = dest

            def start(when=0.0):
                ctx["_scheduled"].append(
                    {
                        "startTime": float(when),
                        "lanes": dict(src["buffer"]["_lanes"]),
                        "frames": src["buffer"]["length"],
                        "stoppedAt": None,
                        "_src": src,
                    }
                )

            def stop():
                for rec in ctx["_scheduled"]:
                    if rec["_src"] is src and rec["stoppedAt"] is None:
                        rec["stoppedAt"] = ctx["currentTime"]

            src["connect"] = connect
            src["start"] = start
            src["stop"] = stop
            return src

        def create_buffer_bound(channels, frames, sr):
            buf = create_buffer(channels, frames, sr)

            def copy_to_channel(lane, ch):
                buf["_lanes"][int(ch)] = [float(v) for v in lane]

            buf["copyToChannel"] = copy_to_channel
            return buf

        ctx["createBuffer"] = create_buffer_bound
        ctx["createBufferSource"] = make_source
        ctx["resume"] = lambda: None
        ctx["close"] = lambda: None
        self.audio_contexts.append(ctx)
        return ctx

    # -- fetch bridge ---------------------------------------------------------
    def fetch(self, url, opts=UNDEF):
        url = str(url)
        self.fetch_log.append(url)
        body = {}
        if isinstance(opts, dict) and isinstance(opts.get("body"), str):
            try:
                body = _json.loads(opts["body"])
            except _json.JSONDecodeError:
                body = {}

        def resp(ok, status, payload=None, raw=None):
            payload = to_js_json(payload)
            return {
                "ok": ok,
                "status": float(status),
                "json": (lambda p=payload: p),
                "arrayBuffer": (lambda r=raw: JSArrayBuffer(r or b"")),
                "read": (lambda r=raw: r),
            }

        if url.startswith("/api/"):
            return self._dispatch(url[5:], body, resp)
        if url == "/player/state":
            self.session.player.tick()
            return resp(True, 200, {"result": self._jsonable(self.session.player.state())})
        if url == "/player/attach_pcm":
            try:
                cfg = self.session.player.attach_remote_audio(
                    int(body.get("sampleRate", 48000)), int(body.get("channels", 2))
                )
            except (ValueError, TypeError) as e:
                return resp(False, 400, {"error": str(e)})
            return resp(True, 200, {"result": self._jsonable(cfg)})
        if url == "/player/detach_pcm":
            self.session.player.detach_remote_audio()
            return resp(True, 200, {"result": None})
        if url == "/player/pcm":
            try:
                chunk = self.session.player.pull_pcm(int(body.get("frames", 4096)))
            except (ValueError, TypeError) as e:
                return resp(False, 400, {"error": str(e)})
            return resp(True, 200, raw=chunk)
        if url == "/media":
            return resp(True, 200, {"result": list(self.media_paths)})
        if url == "/pending_open_paths":
            return resp(True, 200, {"result": []})
        if url == "/upload":
            # multipart bridge: the fake FormData carried a fake File dict
            # {"name", "bytes"}; store like the real handler and return the
            # server path
            import tempfile

            fd = opts.get("body") if isinstance(opts, dict) else None
            f = fd.get("_file") if isinstance(fd, dict) else None
            if not isinstance(f, dict) or "name" not in f:
                return resp(False, 400, {"error": "expected multipart field 'file'"})
            updir = pathlib.Path(tempfile.gettempdir()) / "thesia_tpu_uploads"
            updir.mkdir(exist_ok=True)
            # unique per-upload subdir, mirroring service.handle_upload
            dest = (
                pathlib.Path(tempfile.mkdtemp(dir=updir))
                / pathlib.Path(f["name"]).name
            )
            dest.write_bytes(f.get("bytes", b""))
            return resp(True, 200, {"result": str(dest)})
        if url == "/debug/metrics":
            from thesia_tpu import obs

            out = obs.summary()
            warmer = self.session.tm.shape_warmer
            out["shape_warmer"] = {
                "compiled": warmer.compiled_count,
                "idle": warmer._pending is None,
            }
            return resp(True, 200, {"result": self._jsonable(out)})
        return resp(False, 404, {"error": f"no route {url}"})

    def _dispatch(self, name, body, resp):
        reply = self.dispatcher.dispatch(name, body)
        ok = reply.status == 200
        if reply.content_type == "application/octet-stream":
            return resp(ok, reply.status, raw=reply.body)
        return resp(ok, reply.status, reply.json())

    # -- install into an interpreter -----------------------------------------
    def install(self, interp):
        g = interp.global_env
        doc = self.doc
        g.declare("document", doc)
        g.declare("window", {
            "addEventListener": lambda n, f, o=UNDEF: doc["addEventListener"](n, f),
            "removeEventListener": lambda n, f, o=UNDEF: None,
            "devicePixelRatio": 1.0,
            # Web Audio: audioplayer.js constructs `new window.AudioContext()`
            "AudioContext": ("__ctor__", lambda *a: self.make_audio_context()),
        })
        g.declare("navigator", {"platform": "Linux x86_64"})
        g.declare("location", {"host": "test", "href": "http://test/"})
        g.declare("innerHeight", 800.0)
        g.declare("innerWidth", 1400.0)
        g.declare("devicePixelRatio", 1.0)
        g.vars["performance"] = {"now": lambda: self.now_ms}
        g.declare("localStorage", {
            "getItem": lambda k: self.local_storage.get(k),
            "setItem": lambda k, v: self.local_storage.__setitem__(k, js_to_string(v)),
        })
        g.declare("getComputedStyle", lambda el: {
            "getPropertyValue": lambda name: el["style"].get(name, "")
        })
        g.declare("setTimeout", self.set_timeout)
        g.declare("clearTimeout", self.clear_timer)
        g.declare("setInterval", self.set_timeout)  # one-shot is enough here
        g.declare("clearInterval", self.clear_timer)
        g.declare("requestAnimationFrame", self.request_frame)
        g.declare("cancelAnimationFrame", lambda h=UNDEF: None)
        g.declare("fetch", self.fetch)
        g.declare("alert", lambda *a: None)
        g.declare("WebSocket", ("__ctor__", lambda url=None: {"send": lambda *a: None, "close": lambda: None}))
        def _formdata():
            fd = {}
            fd["append"] = lambda _name, value=UNDEF: fd.__setitem__("_file", value)
            return fd

        g.declare("FormData", ("__ctor__", _formdata))
        g.declare("BigInt", lambda v: float(v))
        g.declare("JSON", {
            "stringify": lambda v, *a: _json.dumps(_plain(v)),
            "parse": lambda s: to_js_json(_json.loads(s)),
        })
        g.declare("Array", {
            "from": _array_from,
            "isArray": lambda v: isinstance(v, list),
        })
        g.declare("Promise", {
            "all": lambda arr: list(arr),
            "resolve": lambda v=UNDEF: v,
        })
        g.declare("ImageData", ("__ctor__", lambda data, w, h=UNDEF: {
            "data": data, "width": w, "height": h,
        }))
        g.declare("createImageBitmap", lambda img: {
            "width": img.get("width", 0.0), "height": img.get("height", 0.0),
            "close": lambda: None,
        })

    def dispatch_event(self, el, name, event=None):
        """Fire an event's registered handlers + on<name> property."""
        ev = dict(event or {})
        ev.setdefault("target", el)
        ev.setdefault("preventDefault", lambda: None)
        stopped = []
        ev.setdefault("stopPropagation", lambda: stopped.append(True))
        cur = el
        while cur is not None:  # simple bubbling, honoring stopPropagation
            for fn in list(cur["_handlers"].get(name, [])):
                fn(ev)
            handler = cur.get(f"on{name}")
            if callable(handler):
                handler(ev)
            if stopped:
                break
            cur = cur.get("_parent")


def _plain(v):
    if v is UNDEF:
        return None
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items() if not k.startswith("_") and not callable(x)}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, float) and v == int(v) and abs(v) < 2**53:
        return int(v)
    return v


def _array_from(arraylike, mapfn=None):
    if isinstance(arraylike, list):
        items = list(arraylike)
    elif isinstance(arraylike, dict) and "length" in arraylike:
        items = [UNDEF] * int(arraylike["length"])
    else:
        items = list(arraylike)
    if mapfn is None or mapfn is UNDEF:
        return items
    return [mapfn(x, float(i)) for i, x in enumerate(items)]
