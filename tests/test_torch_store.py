"""The port's control plane (kubeflow_tpu_torch/cluster/): the cases of
tests/test_store.py (CRUD, optimistic concurrency, finalizers, watches,
apply, conditions and events, the normalizer's lock scope) and
tests/test_reconciler.py (level-triggered reconcile, secondary watches,
requeue, error backoff, background mode) against the port's StateStore
and ControllerManager, and the same script of writes through both
packages' stores giving the same objects and watch events."""

import threading

import pytest

pytest.importorskip("torch")

from kubeflow_tpu.utils.retry import wait_for  # noqa: E402
from kubeflow_tpu_torch.cluster.objects import (  # noqa: E402
    condition_is_true,
    get_condition,
    new_object,
    set_condition,
    set_owner,
)
from kubeflow_tpu_torch.cluster.reconciler import (  # noqa: E402
    Controller,
    ControllerManager,
    Result,
)
from kubeflow_tpu_torch.cluster.store import (  # noqa: E402
    AlreadyExists,
    Conflict,
    NotFound,
    StateStore,
    WatchEvent,
)


@pytest.fixture
def store():
    return StateStore()


class TestCrud:
    def test_create_get(self, store):
        obj = new_object("TPUJob", "j1", "team-a", spec={"topology": "v5e-16"})
        created = store.create(obj)
        assert created["metadata"]["uid"]
        assert created["metadata"]["resourceVersion"] == "1"
        got = store.get("TPUJob", "j1", "team-a")
        assert got["spec"]["topology"] == "v5e-16"

    def test_create_duplicate(self, store):
        store.create(new_object("TPUJob", "j1"))
        with pytest.raises(AlreadyExists):
            store.create(new_object("TPUJob", "j1"))

    def test_get_missing(self, store):
        with pytest.raises(NotFound):
            store.get("TPUJob", "nope")
        assert store.try_get("TPUJob", "nope") is None

    def test_update_bumps_rv(self, store):
        obj = store.create(new_object("TPUJob", "j1"))
        obj["spec"]["x"] = 1
        updated = store.update(obj)
        assert int(updated["metadata"]["resourceVersion"]) > int(
            obj["metadata"]["resourceVersion"]
        )

    def test_update_conflict(self, store):
        obj = store.create(new_object("TPUJob", "j1"))
        store.update(dict(obj, spec={"a": 1}))
        with pytest.raises(Conflict):
            store.update(dict(obj, spec={"b": 2}))  # stale rv

    def test_deepcopy_isolation(self, store):
        obj = store.create(new_object("TPUJob", "j1", spec={"n": 1}))
        obj["spec"]["n"] = 99
        assert store.get("TPUJob", "j1")["spec"]["n"] == 1

    def test_list_by_namespace_and_labels(self, store):
        store.create(new_object("Pod", "p1", "ns1", labels={"job": "a"}))
        store.create(new_object("Pod", "p2", "ns1", labels={"job": "b"}))
        store.create(new_object("Pod", "p3", "ns2", labels={"job": "a"}))
        assert len(store.list("Pod")) == 3
        assert len(store.list("Pod", "ns1")) == 2
        assert len(store.list("Pod", label_selector={"job": "a"})) == 2
        assert len(store.list("Pod", "ns1", {"job": "a"})) == 1

    def test_delete(self, store):
        store.create(new_object("Pod", "p1"))
        store.delete("Pod", "p1")
        assert store.try_get("Pod", "p1") is None

    def test_patch_status(self, store):
        store.create(new_object("TPUJob", "j1"))
        store.patch_status("TPUJob", "j1", "default", {"phase": "Running"})
        assert store.get("TPUJob", "j1")["status"]["phase"] == "Running"


class TestFinalizers:
    def test_delete_with_finalizer_pends(self, store):
        obj = new_object("Profile", "u1")
        obj["metadata"]["finalizers"] = ["profile-cleanup"]
        store.create(obj)
        store.delete("Profile", "u1")
        got = store.get("Profile", "u1")
        assert got["metadata"]["deletionTimestamp"]
        # removing the finalizer completes deletion
        got["metadata"]["finalizers"] = []
        store.update(got)
        assert store.try_get("Profile", "u1") is None


class TestWatch:
    def test_watch_events_in_order(self, store):
        w = store.watch(kind="Pod")
        store.create(new_object("Pod", "p1"))
        obj = store.get("Pod", "p1")
        obj["spec"]["image"] = "x"
        store.update(obj)
        store.delete("Pod", "p1")
        events = [w.q.get_nowait() for _ in range(3)]
        assert [e.type for e in events] == [
            WatchEvent.ADDED,
            WatchEvent.MODIFIED,
            WatchEvent.DELETED,
        ]
        store.close_watch(w)

    def test_watch_filters_kind(self, store):
        w = store.watch(kind="Pod")
        store.create(new_object("Service", "s1"))
        store.create(new_object("Pod", "p1"))
        ev = w.q.get_nowait()
        assert ev.object["kind"] == "Pod"
        assert w.q.empty()


class TestApply:
    def test_apply_creates_then_updates(self, store):
        obj = new_object("Service", "svc", spec={"port": 80})
        store.apply(obj)
        obj2 = new_object("Service", "svc", spec={"port": 81})
        applied = store.apply(obj2)
        assert applied["spec"]["port"] == 81
        assert len(store.list("Service")) == 1


class TestConditionsAndEvents:
    def test_set_get_condition(self, store):
        obj = new_object("TPUJob", "j1")
        changed = set_condition(obj, "Running", "True", reason="AllPodsReady")
        assert changed
        assert condition_is_true(obj, "Running")
        # same again: no change
        assert not set_condition(obj, "Running", "True", reason="AllPodsReady")
        assert get_condition(obj, "Missing") is None

    def test_record_event(self, store):
        job = store.create(new_object("TPUJob", "j1"))
        store.record_event(job, "Created", "gang created")
        evs = store.events_for(job)
        assert len(evs) == 1
        assert evs[0]["reason"] == "Created"

    def test_owner_reference(self, store):
        job = store.create(new_object("TPUJob", "j1"))
        pod = new_object("Pod", "j1-w0")
        set_owner(pod, job)
        assert pod["metadata"]["ownerReferences"][0]["kind"] == "TPUJob"


class TestNormalizerLockScope:
    """Regression coverage for the _normalize fix: the registered
    callback list is SNAPSHOTTED under the store lock (add_normalizer
    appends concurrently), but the callbacks themselves run OUTSIDE it —
    a conversion hook must not serialize every write path behind user
    code, and it may call back into the store freely."""

    def test_normalizer_runs_outside_the_store_lock(self, store):
        import threading

        result = {}

        def probe():
            # from ANOTHER thread: if create() still held the store lock
            # while running normalizers, this acquire would time out
            ok = store._lock.acquire(timeout=2)
            if ok:
                store._lock.release()
            result["acquired"] = ok

        def normalizer(obj):
            t = threading.Thread(target=probe, daemon=True)
            t.start()
            t.join(timeout=5)

        store.add_normalizer("TPUJob", normalizer)
        store.create(new_object("TPUJob", "j-norm", "team-a"))
        assert result.get("acquired") is True

    def test_registration_during_write_storm_is_safe(self, store):
        import threading

        stop = threading.Event()
        registered = 0

        def register():
            nonlocal registered
            while not stop.is_set() and registered < 500:
                store.add_normalizer("TPUJob", lambda obj: None)
                registered += 1

        t = threading.Thread(target=register, daemon=True)
        t.start()
        try:
            for i in range(100):
                store.create(new_object("TPUJob", f"j-storm-{i}", "team-a"))
        finally:
            stop.set()
            t.join(timeout=5)
        assert len(store.list("TPUJob", "team-a")) == 100


class CountingController(Controller):
    kind = "Widget"
    name = "widget-controller"

    def __init__(self):
        super().__init__()
        self.seen = []
        self.lock = threading.Lock()

    def reconcile(self, store, namespace, name):
        with self.lock:
            self.seen.append((namespace, name))
        obj = store.try_get("Widget", name, namespace)
        if obj is None:
            return Result()
        if obj["status"].get("phase") != "Ready":
            store.patch_status("Widget", name, namespace, {"phase": "Ready"})
        return Result()


class TestRunUntilIdle:
    def test_reconciles_existing_objects(self):
        store = StateStore()
        store.create(new_object("Widget", "w1"))
        store.create(new_object("Widget", "w2", "other"))
        c = CountingController()
        cm = ControllerManager(store)
        cm.register(c)
        cm.run_until_idle()
        assert ("default", "w1") in c.seen
        assert ("other", "w2") in c.seen
        assert store.get("Widget", "w1")["status"]["phase"] == "Ready"

    def test_watch_triggers_reconcile(self):
        store = StateStore()
        c = CountingController()
        cm = ControllerManager(store)
        cm.register(c)
        cm.run_until_idle()
        n0 = len(c.seen)
        store.create(new_object("Widget", "late"))
        cm.run_until_idle()
        assert ("default", "late") in c.seen[n0:]

    def test_secondary_watch_maps_to_owner(self):
        store = StateStore()

        class OwnerController(CountingController):
            def __init__(self):
                super().__init__()
                self.watches = {"Pod": self.map_owned}

        c = OwnerController()
        cm = ControllerManager(store)
        cm.register(c)
        owner = store.create(new_object("Widget", "w1"))
        cm.run_until_idle()
        n0 = len(c.seen)
        pod = new_object("Pod", "w1-pod")
        set_owner(pod, owner)
        store.create(pod)
        cm.run_until_idle()
        assert ("default", "w1") in c.seen[n0:]

    def test_requeue_after(self):
        store = StateStore()

        class Periodic(Controller):
            kind = "Widget"
            name = "periodic"

            def __init__(self):
                super().__init__()
                self.count = 0

            def reconcile(self, s, ns, name):
                self.count += 1
                if self.count < 3:
                    return Result(requeue_after_s=0.02)
                return Result()

        c = Periodic()
        cm = ControllerManager(store)
        cm.register(c)
        store.create(new_object("Widget", "w"))
        cm.run_until_idle(max_seconds=5)
        assert c.count == 3

    def test_error_backoff_then_success(self):
        store = StateStore()

        class Flaky(Controller):
            kind = "Widget"
            name = "flaky"

            def __init__(self):
                super().__init__()
                self.attempts = 0

            def reconcile(self, s, ns, name):
                self.attempts += 1
                if self.attempts < 3:
                    raise RuntimeError("boom")
                return Result()

        c = Flaky()
        cm = ControllerManager(store)
        cm.register(c)
        store.create(new_object("Widget", "w"))
        cm.run_until_idle(max_seconds=5)
        assert c.attempts == 3


class TestBackgroundMode:
    def test_start_stop_processes_events(self):
        store = StateStore()
        c = CountingController()
        cm = ControllerManager(store)
        cm.register(c)
        cm.start()
        try:
            store.create(new_object("Widget", "bg"))
            wait_for(
                lambda: store.get("Widget", "bg")["status"].get("phase") == "Ready",
                timeout_s=5,
                desc="widget ready",
            )
        finally:
            cm.stop()


# -- both packages' stores on one script ------------------------------------


def _script(objects, store_cls):
    """One script of writes (create, update, a stale update, apply,
    finalizer-gated delete, cascade GC, status patch, an event) on a
    fresh store of `store_cls` → (every object left, the watch's event
    types and kinds, the errors raised), with uids, timestamps and event
    names (random suffixes) normalised."""
    store = store_cls()
    w = store.watch()
    errors = []
    job = store.create(objects.new_object("Job", "j", "ns", spec={"n": 1}))
    stale = dict(job)
    job["spec"]["n"] = 2
    job = store.update(job)
    try:
        store.update(dict(stale, spec={"n": 3}))
    except Exception as e:  # noqa: BLE001 - the class is compared
        errors.append(type(e).__name__)
    pod = objects.new_object("Pod", "j-0", "ns", labels={"job": "j"})
    objects.set_owner(pod, job)
    store.create(pod)
    store.apply(objects.new_object("Service", "svc", "ns", spec={"p": 80}))
    store.apply(objects.new_object("Service", "svc", "ns", spec={"p": 81}))
    store.apply(objects.new_object("Service", "svc", "ns", spec={"p": 81}))
    fin = objects.new_object("Profile", "u", "ns")
    fin["metadata"]["finalizers"] = ["cleanup"]
    store.create(fin)
    store.delete("Profile", "u", "ns")
    store.patch_status("Job", "j", "ns", {"phase": "Running"})
    store.record_event(store.get("Job", "j", "ns"), "Created", "made")
    try:
        store.create(objects.new_object("Job", "j", "ns"))
    except Exception as e:  # noqa: BLE001 - the class is compared
        errors.append(type(e).__name__)
    store.delete("Job", "j", "ns")
    got = store.get("Profile", "u", "ns")
    got["metadata"]["finalizers"] = []
    store.update(got)
    events = []
    while not w.q.empty():
        ev = w.q.get_nowait()
        events.append((ev.type, ev.object["kind"], ev.object["metadata"]
                       .get("name", "").split(".")[0]))
    store.close_watch(w)

    def norm(o):
        m = dict(o["metadata"])
        for key in ("uid", "creationTimestamp", "deletionTimestamp"):
            m.pop(key, None)
        m["name"] = m["name"].split(".")[0]
        m["ownerReferences"] = [dict(r, uid="") for r in
                                m.get("ownerReferences", [])]
        out = dict(o, metadata=m)
        out.pop("lastTimestamp", None)
        if "involvedObject" in out:
            out["involvedObject"] = dict(out["involvedObject"], uid="")
        return out

    left = {k: [norm(o) for o in store.list(k)]
            for k in ("Job", "Pod", "Service", "Profile", "Event")}
    return left, events, errors


def test_a_script_of_writes_leaves_both_packages_stores_alike():
    from kubeflow_tpu.cluster import objects as jax_objects
    from kubeflow_tpu.cluster.store import StateStore as JaxStateStore
    from kubeflow_tpu_torch.cluster import objects as port_objects

    want = _script(jax_objects, JaxStateStore)
    got = _script(port_objects, StateStore)
    assert got == want
    left, events, errors = got
    assert errors == ["Conflict", "AlreadyExists"]
    # the owned pod went with its job; the finalized profile at the end
    assert left["Pod"] == [] and left["Profile"] == []
    assert [e for e in events if e[0] == "DELETED"] == [
        ("DELETED", "Job", "j"), ("DELETED", "Pod", "j-0"),
        ("DELETED", "Profile", "u")]
