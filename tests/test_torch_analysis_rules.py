"""The port's python-layer rules (TPU001, TPU004, TPU005, TPU009): the
mirrors of ``tests/test_analysis.py``'s rule fixtures in the port's
layout (``tpufw_torch/workloads/env.py``, ``tpufw_torch/obs/events.py``,
``docs/torch/``), TPU001 fixtures for torch's tracers and sync
primitives, and parity cases: one fixture tree, written in each
package's layout, goes through ``tpufw``'s checker and the port's, and
the findings agree in (rule, path after the package prefix, line,
symbol)."""

import pytest

from tests.torch_lint import keys, parity, run_fixture

# ---------------------------------------------------------------- TPU001


def test_tpu001_traced_sync_positive(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "@torch.compile\n"
                "def step(state, batch):\n"
                "    return helper(state, batch)\n"
                "def helper(state, batch):\n"
                "    return batch['x'].item()\n"
            )
        },
        rules=["TPU001"],
    )
    assert any(".item()" in f.symbol for f in out), keys(out)
    # reachability: the finding is inside helper, traced via step
    assert any("helper" in f.symbol for f in out), keys(out)


def test_tpu001_traced_io_positive(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "@torch.compile\n"
                "def step(x):\n"
                "    print('x', x)\n"
                "    return x\n"
            )
        },
        rules=["TPU001"],
    )
    assert any("print" in f.symbol for f in out), keys(out)


def test_tpu001_hostloop_positive(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "loop.py": (
                "import numpy as np\n"
                "def run(src, meter, train):\n"
                "    for batch in timed_batches(src, meter):\n"
                "        loss = train(batch)\n"
                "        bad = float(loss)\n"
                "        worse = np.asarray(loss)\n"
            )
        },
        rules=["TPU001"],
    )
    syms = keys(out)
    assert any("float(loss)" in s for s in syms), syms
    assert any("np.asarray" in s for s in syms), syms


def test_tpu001_hostloop_allowlisted_receiver(tmp_path):
    # meter.stop(float(loss)) is the designed sync window; tel.emit's
    # argument subtree rides the same exemption.
    out = run_fixture(
        tmp_path,
        {
            "loop.py": (
                "def run(src, meter, tel, train):\n"
                "    for batch in timed_batches(src, meter):\n"
                "        loss = train(batch)\n"
                "        meter.stop(float(loss))\n"
                "        tel.events.emit('step', loss=loss.item())\n"
            )
        },
        rules=["TPU001"],
    )
    assert out == [], keys(out)


def test_tpu001_negative_outside_hot_scopes(tmp_path):
    # Syncs in plain functions (nothing traced, no timed_batches) are fine.
    out = run_fixture(
        tmp_path,
        {
            "cold.py": (
                "import numpy as np\n"
                "import torch\n"
                "def summarize(t):\n"
                "    print('done')\n"
                "    torch.cuda.synchronize()\n"
                "    return float(np.asarray(t.cpu()).mean()) + t.item()\n"
            )
        },
        rules=["TPU001"],
    )
    assert out == [], keys(out)


def test_tpu001_suppressed(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "@torch.compile\n"
                "def step(x):\n"
                "    print('x', x)  # tpulint: disable=TPU001 — debug\n"
                "    return x\n"
            )
        },
        rules=["TPU001"],
    )
    assert out == [], keys(out)


@pytest.mark.parametrize("expr,symbol", [
    ("loss.item()", ".item()"),
    ("loss.tolist()", ".tolist()"),
    ("loss.cpu()", ".cpu()"),
    ("loss.detach().numpy()", ".numpy()"),
    ("loss.to('cpu')", ".to(cpu)"),
    ("loss.to(device='cpu')", ".to(cpu)"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("torch.cuda.current_stream().synchronize()", "synchronize"),
    ("time.sleep(0.1)", "time.sleep"),
])
def test_tpu001_torch_sync_primitives_in_the_step_loop(tmp_path, expr,
                                                       symbol):
    out = run_fixture(
        tmp_path,
        {
            "loop.py": (
                "import time\n"
                "import torch\n"
                "def run(src, meter, train):\n"
                "    for batch in timed_batches(src, meter):\n"
                "        loss = train(batch)\n"
                f"        v = {expr}\n"
            )
        },
        rules=["TPU001"],
    )
    assert keys(out) == [f"hotloop:run:{symbol}"], keys(out)
    assert out[0].line == 6 and out[0].severity == "warning"


@pytest.mark.parametrize("expr", [
    "loss.to(device)",
    "loss.to('cuda', non_blocking=True)",
    "loss.cpu(memory_format)",
    "loss.detach()",
    "float(2 * lr)",
])
def test_tpu001_device_side_calls_negative(tmp_path, expr):
    out = run_fixture(
        tmp_path,
        {
            "loop.py": (
                "def run(src, meter, train, device, lr, memory_format):\n"
                "    for batch in timed_batches(src, meter):\n"
                "        loss = train(batch)\n"
                f"        v = {expr}\n"
            )
        },
        rules=["TPU001"],
    )
    assert out == [], keys(out)


@pytest.mark.parametrize("tracing,how", [
    ("@torch.compile\ndef step(x):", "@torch.compile"),
    ("@torch.compile(mode='max-autotune')\ndef step(x):", "@torch.compile"),
    ("@torch.jit.script\ndef step(x):", "@jit.script"),
    ("@jit.script\ndef step(x):", "@jit.script"),
    ("@script\ndef step(x):", "@jit.script"),
    ("@partial(torch.compile, fullgraph=True)\ndef step(x):",
     "@torch.compile"),
])
def test_tpu001_torch_tracer_decorators(tmp_path, tracing, how):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "from functools import partial\n"
                "from torch import jit\n"
                "from torch.jit import script\n"
                f"{tracing}\n"
                "    return x.cpu()\n"
            )
        },
        rules=["TPU001"],
    )
    assert keys(out) == ["traced:step:.cpu()"], keys(out)
    assert how in out[0].message and out[0].severity == "error"


def test_tpu001_torch_tracer_calls(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "def a(x):\n"
                "    return x.tolist()\n"
                "def b(x):\n"
                "    return x.numpy()\n"
                "def c(x):\n"
                "    return helper(x)\n"
                "def helper(x):\n"
                "    return x.item()\n"
                "fa = torch.compile(a)\n"
                "fb = torch.jit.trace(b, (torch.zeros(2),))\n"
                "fc = torch.cuda.make_graphed_callables(c, (torch.zeros(2),))\n"
                "fd = torch.compile(lambda x: print(x))\n"
            )
        },
        rules=["TPU001"],
    )
    assert sorted(keys(out)) == [
        "traced:<lambda>:print", "traced:a:.tolist()", "traced:b:.numpy()",
        "traced:helper:.item()",
    ], keys(out)


def test_tpu001_cuda_graph_capture_body(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import torch\n"
                "def capture(model, x, g):\n"
                "    def inner(y):\n"
                "        return y.item()\n"
                "    with torch.cuda.graph(g):\n"
                "        out = model(x)\n"
                "        torch.cuda.synchronize()\n"
                "        inner(out)\n"
                "    return out.cpu()\n"
            )
        },
        rules=["TPU001"],
    )
    # The capture body and what it calls are traced; the code after the
    # block is not.
    assert sorted(keys(out)) == [
        "traced:capture.<cuda.graph>:synchronize",
        "traced:capture.inner:.item()",
    ], keys(out)


def test_tpu001_unrelated_compile_is_not_a_tracer(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            "mod.py": (
                "import re\n"
                "def pattern(x):\n"
                "    return x.item()\n"
                "P = re.compile(pattern)\n"
                "Q = compile(pattern, 'f', 'exec')\n"
            )
        },
        rules=["TPU001"],
    )
    assert out == [], keys(out)


# ---------------------------------------------------------------- TPU004

ENV_DOC = "# knobs\n`TPUFW_ALPHA`, `TPUFW_BETA_STEPS`\n"
ENV_AT = "docs/torch/ENV.md"


def test_tpu004_direct_read_positive(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: ENV_DOC + "`TPUFW_GAMMA`\n",
            "mod.py": (
                "import os\n"
                'GAMMA = os.environ.get("TPUFW_GAMMA")\n'
            ),
        },
        rules=["TPU004"],
    )
    assert "direct-read:TPUFW_GAMMA" in keys(out), keys(out)


def test_tpu004_undocumented_positive(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: ENV_DOC,
            # tpufw's catalog does not document the port's knobs.
            "docs/ENV.md": "`TPUFW_DELTA_STEPS`\n",
            "mod.py": (
                "from tpufw_torch.workloads.env import env_int\n"
                'STEPS = env_int("delta_steps", 5)\n'
            ),
        },
        rules=["TPU004"],
    )
    assert "undocumented:TPUFW_DELTA_STEPS" in keys(out), keys(out)


def test_tpu004_helper_documented_negative(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: ENV_DOC,
            "mod.py": (
                "from tpufw_torch.workloads.env import env_int, env_str\n"
                'ALPHA = env_str("alpha", "x")\n'
                'BETA = env_int("beta_steps", 5)\n'
            ),
        },
        rules=["TPU004"],
    )
    assert out == [], keys(out)


def test_tpu004_stale_doc_warning(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: ENV_DOC,  # documents ALPHA + BETA_STEPS
            # A deploy/ mention does not keep the port's entry alive.
            "deploy/a.yaml": "- name: TPUFW_BETA_STEPS\n",
            "mod.py": (
                "from tpufw_torch.workloads.env import env_str\n"
                'ALPHA = env_str("alpha", "x")\n'
            ),
        },
        rules=["TPU004"],
    )
    assert keys(out) == ["stale-doc:TPUFW_BETA_STEPS"], keys(out)
    assert out[0].severity == "warning" and out[0].path == ENV_AT


def test_tpu004_near_duplicate_warning(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: "`TPUFW_EVAL_EVERY` `TPUFW_EVAL_EVERZ`\n",
            "mod.py": (
                "from tpufw_torch.workloads.env import env_int\n"
                'A = env_int("eval_every", 1)\n'
                'B = env_int("eval_everz", 1)\n'
            ),
        },
        rules=["TPU004"],
    )
    assert any(s.startswith("near-duplicate:") for s in keys(out)), keys(out)


def test_tpu004_env_module_itself_exempt(tmp_path):
    # The helpers' own os.environ.get is the one sanctioned read.
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: "",
            "tpufw_torch/workloads/env.py": (
                "import os\n"
                "def _get(name):\n"
                '    return os.environ.get(f"TPUFW_{name.upper()}")\n'
            ),
        },
        rules=["TPU004"],
    )
    assert out == [], keys(out)


def test_tpu004_file_suppression(tmp_path):
    out = run_fixture(
        tmp_path,
        {
            ENV_AT: "`TPUFW_GAMMA`\n",
            "mod.py": (
                "# tpulint: disable-file=TPU004 — injectable env boundary\n"
                "import os\n"
                'GAMMA = os.environ.get("TPUFW_GAMMA")\n'
            ),
        },
        rules=["TPU004"],
    )
    assert out == [], keys(out)


# ---------------------------------------------------------------- TPU005

EVENTS = 'SCHEMA = {"step": (), "eval": (), "run_start": ()}\n'
OBS_DOC = "catalog: `tpufw_steps_total`, `tpufw_serve_requests_total`\n"
OBS = {"tpufw_torch/obs/events.py": EVENTS,
       "docs/torch/OBSERVABILITY.md": OBS_DOC}


def test_tpu005_bad_event_kind(tmp_path):
    out = run_fixture(
        tmp_path,
        {**OBS, "mod.py": ("def g(tel):\n"
                           '    tel.events.emit("stepp", loss=1.0)\n')},
        rules=["TPU005"],
    )
    assert keys(out) == ["event-kind:stepp"], keys(out)


def test_tpu005_good_event_kind_negative(tmp_path):
    out = run_fixture(
        tmp_path,
        {**OBS, "mod.py": ("def g(tel):\n"
                           '    tel.events.emit("step", loss=1.0)\n')},
        rules=["TPU005"],
    )
    assert out == [], keys(out)


def test_tpu005_metric_not_in_catalog(tmp_path):
    out = run_fixture(
        tmp_path,
        {**OBS,
         # tpufw's catalog does not count for the port.
         "docs/OBSERVABILITY.md": "`tpufw_stepz_total`\n",
         "mod.py": ("def g(reg):\n"
                    '    return reg.counter("tpufw_stepz_total")\n')},
        rules=["TPU005"],
    )
    assert keys(out) == ["metric:tpufw_stepz_total"], keys(out)


def test_tpu005_metric_prefix_enforced(tmp_path):
    out = run_fixture(
        tmp_path,
        {**OBS, "mod.py": ("def g(reg):\n"
                           '    return reg.gauge("queue_depth")\n')},
        rules=["TPU005"],
    )
    assert keys(out) == ["metric-prefix:queue_depth"], keys(out)


def test_tpu005_wrapper_short_names(tmp_path):
    # serve.py idiom: a PREFIX-carrying wrapper; short names at call
    # sites are checked as PREFIX + name against the doc catalog.
    out = run_fixture(
        tmp_path,
        {**OBS, "serve.py": (
            "class _Metrics:\n"
            '    PREFIX = "tpufw_serve_"\n'
            "    def inc(self, name, n=1):\n"
            "        pass\n"
            "def handle(metrics):\n"
            '    metrics.inc("requests_total")\n'
            '    metrics.inc("requestz_total")\n'
        )},
        rules=["TPU005"],
    )
    assert keys(out) == ["metric:tpufw_serve_requestz_total"], keys(out)


# ---------------------------------------------------------------- TPU009

_THREADED_HEADER = "import threading\n"


def _tpu009(tmp_path, body):
    return run_fixture(tmp_path, {"mod.py": _THREADED_HEADER + body},
                       rules=["TPU009"])


CALLER_UNGUARDED = (
    "class Pool:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._count = 0\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._count += 1\n"
    "    def count(self):\n"
    "        return self._count\n"
)
DUAL_WRITER = (
    "class Sched:\n"
    "    def __init__(self):\n"
    "        self._cv = threading.Condition()\n"
    "        self._idx = 0\n"
    "        self._t = threading.Thread(target=self._run)\n"
    "    def _run(self):\n"
    "        self._idx += 1\n"
    "    def reset(self):\n"
    "        with self._cv:\n"
    "            self._idx = 0\n"
)
LOCK_ORDER = (
    "class Two:\n"
    "    def __init__(self):\n"
    "        self._a = threading.Lock()\n"
    "        self._b = threading.Lock()\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        with self._a:\n"
    "            with self._b:\n"
    "                pass\n"
    "    def poke(self):\n"
    "        with self._b:\n"
    "            with self._a:\n"
    "                pass\n"
)
LOCKED = (
    "class Safe:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._items = []\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._items.append(1)\n"
    "    def drain(self):\n"
    "        with self._lock:\n"
    "            out = list(self._items)\n"
    "            self._items.clear()\n"
    "            return out\n"
)
SINGLE_WRITER = (
    "class Owner:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._n = 0\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        self._n += 1\n"
    "        if self._n > 3:\n"
    "            self._n = 0\n"
    "    def peek(self):\n"
    "        with self._lock:\n"
    "            return self._n\n"
)
THREADSAFE = (
    "import queue\n"
    "class Q:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._q = queue.Queue()\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        self._q.put(1)\n"
    "    def pop(self):\n"
    "        return self._q.get()\n"
)
GUARDED_HELPER = (
    "class H:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._state = {}\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        with self._lock:\n"
    "            self._bump()\n"
    "    def _bump(self):\n"
    "        self._state['n'] = 1\n"
    "    def read(self):\n"
    "        with self._lock:\n"
    "            return dict(self._state)\n"
)
# The shape of the port's serve scheduler (`_SlotScheduler`): the
# worker retires a pool and folds its peak; a scrape read both lock-free.
POOL_SWAP = (
    "class Sched:\n"
    "    def __init__(self):\n"
    "        self._cv = threading.Condition()\n"
    "        self._pool = None\n"
    "        self._peak = 0\n"
    "        self._t = threading.Thread(target=self._loop)\n"
    "    def _loop(self):\n"
    "        self._build()\n"
    "    def _build(self):\n"
    "        {fold}\n"
    "    def peak(self):\n"
    "        {read}\n"
)
FOLD_BARE = ("if self._pool is not None:\n"
             "            self._peak = max(self._peak, self._pool.peak)\n"
             "        self._pool = None")
FOLD_LOCKED = ("with self._cv:\n"
               "            if self._pool is not None:\n"
               "                self._peak = max(self._peak, self._pool.peak)\n"
               "            self._pool = None")
READ_BARE = ("pool = self._pool\n"
             "        return max(self._peak, pool.peak if pool else 0)")
READ_LOCKED = ("with self._cv:\n"
               "            pool = self._pool\n"
               "            return max(self._peak, pool.peak if pool else 0)")


def test_tpu009_caller_side_unguarded_read_positive(tmp_path):
    assert keys(_tpu009(tmp_path, CALLER_UNGUARDED)) == [
        "unguarded:Pool._count"]


def test_tpu009_dual_writer_positive(tmp_path):
    # Written from both sides: every access needs the lock, including
    # the thread's own increment.
    assert keys(_tpu009(tmp_path, DUAL_WRITER)) == ["unguarded:Sched._idx"]


def test_tpu009_lock_order_inversion_positive(tmp_path):
    out = _tpu009(tmp_path, LOCK_ORDER)
    assert keys(out) == ["lock-order:Two:_a,_b"], keys(out)
    assert out[0].severity == "warning"


def test_tpu009_lock_held_via_with_negative(tmp_path):
    assert _tpu009(tmp_path, LOCKED) == []


def test_tpu009_single_writer_owner_negative(tmp_path):
    # The scheduler thread owns the attribute (all writes), touches it
    # lock-free; callers read under the lock.
    assert _tpu009(tmp_path, SINGLE_WRITER) == []


def test_tpu009_threadsafe_container_negative(tmp_path):
    assert _tpu009(tmp_path, THREADSAFE) == []


def test_tpu009_guarded_helper_negative(tmp_path):
    # A private helper whose every internal call site holds the lock
    # inherits the guard — no re-acquire needed inside.
    assert _tpu009(tmp_path, GUARDED_HELPER) == []


@pytest.mark.parametrize("fold,read,want", [
    (FOLD_BARE, READ_BARE, ["unguarded:Sched._peak", "unguarded:Sched._pool"]),
    (FOLD_LOCKED, READ_LOCKED, []),
])
def test_tpu009_pool_swap(tmp_path, fold, read, want):
    out = _tpu009(tmp_path, POOL_SWAP.format(fold=fold, read=read))
    assert sorted(keys(out)) == want


# ---------------------------------------------------------------- parity
#
# Paths and sources carry {pkg} (tpufw | tpufw_torch) and {docs} (docs |
# docs/torch); tests/torch_lint.py writes the tree in each layout.

PARITY = {
    "TPU001": {
        "{pkg}/train/loop.py": (
            "import time\n"
            "import numpy as np\n"
            "def run(src, meter, tel, train):\n"
            "    def window(x):\n"
            "        print('w', x)\n"
            "        return int(x)\n"
            "    for batch in timed_batches(src, meter):\n"
            "        loss = train(batch)\n"
            "        meter.stop(float(loss))\n"
            "        tel.events.emit('step', loss=float(loss))\n"
            "        a = float(loss)\n"
            "        b = np.asarray(batch['x'])\n"
            "        c = loss.item()\n"
            "        time.sleep(0.01)\n"
            "        window(loss)\n"
            "        d = float(batch['y'])  # tpulint: disable=TPU001 — ok\n"
            "    while True:\n"
            "        e = int(loss)\n"
            "        break\n"
            "def cold(x):\n"
            "    print(float(np.asarray(x)), x.item())\n"
        ),
    },
    "TPU004": {
        "{docs}/ENV.md": (
            "| `TPUFW_ALPHA` | str | x | a |\n"
            "| `TPUFW_BETA_STEPS` | int | 5 | b |\n"
            "| `TPUFW_EVAL_EVERY` | int | 1 | c |\n"
            "| `TPUFW_STALE` | int | 1 | d |\n"
        ),
        "{pkg}/workloads/env.py": (
            "import os\n"
            "def _get(name):\n"
            '    return os.environ.get(f"TPUFW_{name.upper()}")\n'
            "def env_str(name, default):\n"
            "    return _get(name) or default\n"
        ),
        "{pkg}/workloads/job.py": (
            "import os\n"
            "from {pkg}.workloads.env import env_int, env_str\n"
            'A = env_str("alpha", "x")\n'
            'B = env_int("beta_steps", 5)\n'
            'C = env_int("eval_every", 1)\n'
            'D = env_int("eval_everz", 1)\n'
            'E = os.environ.get("TPUFW_GAMMA")\n'
            'F = os.environ["TPUFW_ALPHA"]\n'
            'G = "TPUFW_DELTA" in os.environ\n'
            'H = os.getenv("TPUFW_EPSILON", "")\n'
            'os.environ["TPUFW_OUT"] = "1"\n'
            'I = env_str("top_k", "")\n'
            'J = env_str("top_p", "")\n'
        ),
        "{pkg}/cluster/boot.py": (
            "# tpulint: disable-file=TPU004 — injectable env boundary\n"
            "import os\n"
            'K = os.environ.get("TPUFW_COORDINATOR")\n'
        ),
    },
    "TPU005": {
        "{pkg}/obs/events.py": EVENTS,
        "{docs}/OBSERVABILITY.md": (
            "`tpufw_steps_total` `tpufw_serve_requests_total` "
            "`tpufw_serve_queue_depth`\n"
        ),
        "{pkg}/serve/mod.py": (
            "NAME = 'tpufw_steps_total'\n"
            "class _Metrics:\n"
            '    PREFIX = "tpufw_serve_"\n'
            "    def inc(self, name, n=1):\n"
            "        pass\n"
            "def g(tel, reg, metrics, name):\n"
            '    tel.events.emit("stepp", loss=1.0)\n'
            '    tel.events.emit("step", loss=1.0)\n'
            "    reg.counter(NAME)\n"
            '    reg.counter("tpufw_stepz_total")\n'
            '    reg.gauge("queue_depth")\n'
            "    reg.histogram(name)\n"
            '    metrics.inc("requests_total")\n'
            '    metrics.inc("requestz_total")\n'
            '    metrics.render({"queue_depth": 1, "uptimez": 2})\n'
        ),
    },
    "TPU009": {
        "{pkg}/serve/threads.py": (
            _THREADED_HEADER + CALLER_UNGUARDED + DUAL_WRITER + LOCK_ORDER
            + LOCKED + SINGLE_WRITER + THREADSAFE.replace(
                "import queue\n", "") + GUARDED_HELPER
            + POOL_SWAP.format(fold=FOLD_BARE, read=READ_BARE).replace(
                "class Sched:", "class Sched2:")
        ),
        "{pkg}/serve/fixed.py": (
            _THREADED_HEADER
            + POOL_SWAP.format(fold=FOLD_LOCKED, read=READ_LOCKED)
        ),
    },
}


@pytest.mark.parametrize("rule", sorted(PARITY))
def test_parity_with_tpufw(tmp_path, rule):
    want, got = parity(tmp_path, PARITY[rule], rule)
    assert got == want
    assert want, "the fixture must make the rule fire"
    assert {r for r, *_ in got} == {rule}
