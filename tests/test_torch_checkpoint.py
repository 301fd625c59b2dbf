"""The port's checkpoints against the JAX package's (mxnet_tpu/
checkpoint.py): one on-disk format, read and written by both.

Every direction is checked bit for bit: v2 and v1 directories the JAX
package writes load in the port (fp32, bf16 and e4m3 included, the
extension dtypes without ``ml_dtypes`` on the port's side), the port's
saves load in the JAX package with the same file names and manifest
keys, corruption quarantines the same epochs in both, and ``fsck``
reports agree.  The rest are twins of tests/test_elastic_checkpoint.py
and tests/test_fault_tolerance.py's manager tests: retention, async
writes and their errors, a multi-host shard layout, stale shards,
overlapping coverage, and the arguments that need several devices
(a later slice).
"""
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    for var in ("MXNET_CKPT_FORMAT", "MXNET_CKPT_ASYNC",
                "MXNET_CKPT_VERIFY", "MXNET_CKPT_JOIN_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _np_args(seed=0):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(8, 8).astype("float32"),
            "fc1_bias": rs.randn(8).astype("float32"),
            "fc2_weight": rs.randn(3, 8).astype("float32"),
            "fc2_bias": rs.randn(3).astype("float32")}


def _jax_args(seed=0):
    return {k: jmx.nd.array(v) for k, v in _np_args(seed).items()}


def _torch_args(seed=0):
    return {k: torch.from_numpy(v) for k, v in _np_args(seed).items()}


def _bits(arr):
    """The raw bytes of an array of either package (or a tensor)."""
    data = getattr(arr, "_data", arr)
    if torch.is_tensor(data):
        t = data.detach().cpu().contiguous()
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(data)).tobytes()


def _flip_bit(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0x01]))


def _extension_arrays():
    """bf16 and e4m3 arrays, as the JAX package holds them."""
    import ml_dtypes

    bf = np.arange(32, dtype=ml_dtypes.bfloat16).reshape(4, 8) / 3
    e4 = (np.arange(16, dtype=np.float32) / 5).astype(
        ml_dtypes.float8_e4m3fn)
    return bf.astype(ml_dtypes.bfloat16), e4


def _load(d, **kw):
    return tck.CheckpointManager(d, prefix="m", **kw).load(device="cpu")


# ---------------------------------------------------------------------------
# JAX-written directories load in the port
# ---------------------------------------------------------------------------

def test_jax_v2_loads_in_port_bit_equal(tmp_path):
    bf, e4 = _extension_arrays()
    args = _jax_args()
    args["w_bf16"] = jmx.nd.array(bf)
    aux = {"stat": jmx.nd.array(np.arange(5, dtype=np.float32))}
    d = str(tmp_path)
    jck.CheckpointManager(d, prefix="m").save(
        symbol=_mlp(jmx), arg_params=args, aux_params=aux, epoch=3,
        nbatch=5)
    # an fp8 parameter rides a second epoch (an NDArray holds no fp8)
    jck.CheckpointManager(d, prefix="m").save(
        symbol=None, arg_params={"q": e4}, aux_params={}, epoch=4)
    st = _load(d, verify=True)
    assert st.epoch == 4 and st.arg_params["q"]._data.dtype == \
        torch.float8_e4m3fn
    assert _bits(st.arg_params["q"]) == e4.tobytes()
    st = tck.CheckpointManager(d, prefix="m").load(epoch=3, device="cpu")
    assert (st.epoch, st.nbatch) == (3, 5)
    assert st.arg_params["w_bf16"]._data.dtype == torch.bfloat16
    assert _bits(st.arg_params["w_bf16"]) == bf.tobytes()
    for k, v in args.items():
        if k != "w_bf16":
            assert _bits(st.arg_params[k]) == _bits(v.asnumpy()), k
    assert _bits(st.aux_params["stat"]) == _bits(aux["stat"].asnumpy())
    assert st.symbol is not None
    assert st.symbol.list_arguments() == _mlp(jmx).list_arguments()


def test_jax_v1_loads_in_port_bit_equal(tmp_path, monkeypatch):
    d = str(tmp_path)
    args = _jax_args(1)
    monkeypatch.setenv("MXNET_CKPT_FORMAT", "1")
    jck.CheckpointManager(d, prefix="m").save(
        symbol=_mlp(jmx), arg_params=args, aux_params={}, epoch=1,
        nbatch=4)
    monkeypatch.delenv("MXNET_CKPT_FORMAT")
    assert not os.path.exists(os.path.join(d, "m-0001.manifest.json"))
    st = _load(d)
    assert (st.epoch, st.nbatch) == (1, 4) and st.manifest is None
    for k, v in args.items():
        assert _bits(st.arg_params[k]) == _bits(v.asnumpy()), k
        assert st.arg_params[k].context == tmx.cpu()


def test_multi_host_shard_layout_assembles(tmp_path):
    """Two shard files each holding half of a global array with index
    windows (the layout a 2-host pod writes), built by hand as in
    tests/test_elastic_checkpoint.py; fp32 and bf16, whole and
    windowed.  A dropped shard fails coverage in both packages."""
    bf, _ = _extension_arrays()
    full = np.arange(16 * 4, dtype="float32").reshape(16, 4)
    d = str(tmp_path)
    shards_meta = []
    for rank, (lo, hi) in enumerate(((0, 8), (8, 16))):
        shard = os.path.join(d, "m-0001.shard%d.params" % rank)
        with open(shard, "wb") as f:
            np.savez(f, **{"arg:w/0": full[lo:hi],
                           "arg:b/0": bf[rank * 2:rank * 2 + 2]})
        shards_meta.append({
            "rank": rank, "file": os.path.basename(shard),
            "sha256": hashlib.sha256(open(shard, "rb").read()).hexdigest(),
            "bytes": os.path.getsize(shard),
            "pieces": {"arg:w/0": {"param": "arg:w",
                                   "index": [[lo, hi], [0, 4]]},
                       "arg:b/0": {"param": "arg:b",
                                   "index": [[rank * 2, rank * 2 + 2],
                                             [0, 8]]}}})
    manifest = {"format": 2, "epoch": 1, "nbatch": 0, "num_update": 0,
                "have_states": False, "num_processes": 2,
                "params": {"arg:w": {"shape": [16, 4], "dtype": "float32",
                                     "spec": None},
                           "arg:b": {"shape": [4, 8], "dtype": "bfloat16",
                                     "spec": None}},
                "shards": shards_meta, "states": None}
    with open(os.path.join(d, "m-0001.manifest.json"), "w") as f:
        json.dump(manifest, f)
    st = _load(d)
    np.testing.assert_array_equal(st.arg_params["w"].asnumpy(), full)
    assert _bits(st.arg_params["b"]) == bf.tobytes()
    js = jck.CheckpointManager(d, prefix="m").load()
    assert _bits(js.arg_params["w"].asnumpy()) == _bits(st.arg_params["w"])
    os.remove(os.path.join(d, "m-0001.shard1.params"))
    with pytest.raises(MXNetError):
        _load(d)


def test_assemble_pieces_reinterprets_void_bytes():
    bf, e4 = _extension_arrays()
    meta = {"w": {"shape": [4, 8], "dtype": "bfloat16", "spec": None},
            "q": {"shape": [16], "dtype": "float8_e4m3fn", "spec": None}}
    out = tck.assemble_pieces([("w", None, bf.view("V2")),
                               ("q", None, e4.view("V1"))], meta)
    assert out["w"].dtype == torch.bfloat16
    assert _bits(out["w"]) == bf.tobytes()
    assert _bits(out["q"]) == e4.tobytes()
    acc = {}
    tck.assemble_pieces([("w", [[0, 2], [0, 8]], bf[0:2].view("V2"))],
                        meta, acc)
    tck.assemble_pieces([("w", [[2, 4], [0, 8]], bf[2:4].view("V2"))],
                        meta, acc)
    assert _bits(acc["w"]) == bf.tobytes()
    with pytest.raises(MXNetError, match="cannot hold"):
        tck.assemble_pieces([("w", None, np.zeros((4, 8), np.float32))],
                            meta)


# ---------------------------------------------------------------------------
# the port's saves load in the JAX package
# ---------------------------------------------------------------------------

def test_port_v2_loads_in_jax_same_files_and_manifest(tmp_path):
    bf, e4 = _extension_arrays()
    targs = _torch_args(2)
    targs["w_bf16"] = torch.from_numpy(bf.view(np.int16)).view(
        torch.bfloat16)
    targs["q"] = torch.from_numpy(e4.view(np.uint8)).view(
        torch.float8_e4m3fn)
    aux = {"stat": torch.arange(5, dtype=torch.float32)}
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    tck.CheckpointManager(td, prefix="m").save(
        symbol=_mlp(tmx), arg_params=targs, aux_params=aux, epoch=2,
        nbatch=3, num_update=17)
    jargs = _jax_args(2)
    jargs["w_bf16"] = bf
    jargs["q"] = e4
    jck.CheckpointManager(jd, prefix="m").save(
        symbol=_mlp(jmx), arg_params=jargs,
        aux_params={"stat": np.arange(5, dtype=np.float32)}, epoch=2,
        nbatch=3, num_update=17)
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "m-0002.manifest.json", "m-0002.shard0.json",
        "m-0002.shard0.params", "m-symbol.json"]
    tman = json.load(open(os.path.join(td, "m-0002.manifest.json")))
    jman = json.load(open(os.path.join(jd, "m-0002.manifest.json")))
    assert sorted(tman) == sorted(jman)
    assert tman["params"] == jman["params"]
    for key in ("format", "epoch", "nbatch", "num_update", "have_states",
                "num_processes", "states"):
        assert tman[key] == jman[key], key
    assert [sorted(s) for s in tman["shards"]] == \
        [sorted(s) for s in jman["shards"]]
    assert tman["shards"][0]["pieces"] == jman["shards"][0]["pieces"]
    js = jck.CheckpointManager(td, prefix="m").load()
    assert (js.epoch, js.nbatch, js.num_update) == (2, 3, 17)
    for k, v in targs.items():
        assert _bits(np.asarray(js.arg_params[k]._data)) == _bits(v), k
    assert _bits(js.aux_params["stat"].asnumpy()) == _bits(aux["stat"])
    assert js.symbol.list_arguments() == _mlp(jmx).list_arguments()


def test_port_v1_loads_in_jax(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv("MXNET_CKPT_FORMAT", "1")
    tck.CheckpointManager(d, prefix="m").save(
        symbol=_mlp(tmx), arg_params=_torch_args(3), aux_params={},
        epoch=1, nbatch=4)
    assert sorted(os.listdir(d)) == ["m-0001.meta.json", "m-0001.params",
                                     "m-symbol.json"]
    monkeypatch.delenv("MXNET_CKPT_FORMAT")
    js = jck.CheckpointManager(d, prefix="m").load()
    assert (js.epoch, js.nbatch) == (1, 4)
    for k, v in _np_args(3).items():
        assert _bits(js.arg_params[k].asnumpy()) == _bits(v), k


def test_module_save_records_states_and_loads_in_jax(tmp_path):
    rs = np.random.RandomState(0)
    X = rs.randn(32, 8).astype("float32")
    y = (X @ rs.randn(8, 3).astype("float32")).argmax(1).astype("float32")
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, y, batch_size=8)
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    mgr = tck.CheckpointManager(str(tmp_path), prefix="m")
    mgr.save(module=mod, epoch=1)
    st = mgr.load(device="cpu")
    assert st.num_update == 4 and st.manifest["have_states"]
    assert st.states_path and os.path.exists(st.states_path)
    js = jck.CheckpointManager(str(tmp_path), prefix="m").load()
    assert js.num_update == 4 and js.states_path
    for k, v in mod.get_params()[0].items():
        assert _bits(st.arg_params[k]) == _bits(v), k
        assert _bits(js.arg_params[k].asnumpy()) == _bits(v), k


# ---------------------------------------------------------------------------
# corruption, quarantine and fsck agree across the packages
# ---------------------------------------------------------------------------

def _three_epochs(d):
    mgr = jck.CheckpointManager(d, prefix="m")
    for e in (1, 2, 3):
        mgr.save(symbol=_mlp(jmx), arg_params=_jax_args(e), aux_params={},
                 epoch=e)


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "manifest"])
def test_corruption_quarantines_same_epochs_in_both(tmp_path, damage):
    src = str(tmp_path / "src")
    _three_epochs(src)
    if damage == "bitflip":
        _flip_bit(os.path.join(src, "m-0003.shard0.params"))
    elif damage == "truncate":
        path = os.path.join(src, "m-0003.shard0.params")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:
        with open(os.path.join(src, "m-0003.manifest.json"), "w") as f:
            f.write("{not json")
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(src, td)
    shutil.copytree(src, jd)
    st = _load(td)
    js = jck.CheckpointManager(jd, prefix="m").load()
    assert st.epoch == js.epoch == 2
    assert _bits(st.arg_params["fc1_weight"]) == \
        _bits(js.arg_params["fc1_weight"].asnumpy())
    assert tck.CheckpointManager(td, "m").epochs() == \
        jck.CheckpointManager(jd, "m").epochs() == [1, 2]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    assert any(n.endswith(".corrupt") for n in os.listdir(td))
    with pytest.raises(tck.CorruptCheckpoint):
        shutil.rmtree(td)
        shutil.copytree(src, td)
        tck.CheckpointManager(td, "m").load(epoch=3, device="cpu")


def test_fsck_reports_agree(tmp_path):
    src = str(tmp_path / "src")
    _three_epochs(src)
    _flip_bit(os.path.join(src, "m-0002.shard0.params"))
    td, jd = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(src, td)
    shutil.copytree(src, jd)
    tmgr, jmgr = tck.CheckpointManager(td, "m"), jck.CheckpointManager(jd,
                                                                     "m")
    for quarantine in (False, True, False):
        trep, jrep = tmgr.fsck(quarantine), jmgr.fsck(quarantine)
        trep.pop("directory")
        jrep.pop("directory")
        for rep in (trep, jrep):  # the problem names the file, not the dir
            for e in rep["epochs"]:
                e["problems"] = [p.replace(td, "D").replace(jd, "D")
                                 for p in e["problems"]]
        assert trep == jrep
    assert trep["ok"] and tmgr.epochs() == [1, 3]


def test_explicit_epoch_corrupt_raises_typed(tmp_path):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m")
    mgr.save(symbol=_mlp(tmx), arg_params=_torch_args(1), epoch=1)
    mgr.save(symbol=_mlp(tmx), arg_params=_torch_args(2), epoch=2)
    _flip_bit(os.path.join(d, "m-0001.shard0.params"))
    _flip_bit(os.path.join(d, "m-0002.shard0.params"))
    with pytest.raises(tck.CorruptCheckpoint, match="checksum mismatch"):
        mgr.load(epoch=2, device="cpu")
    with pytest.raises(MXNetError, match="candidate failed"):
        mgr.load(device="cpu")
    with pytest.raises(MXNetError, match="no checkpoint found"):
        mgr.load(device="cpu")


def test_verify_opt_out_and_env(tmp_path, monkeypatch):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m", verify=False)
    mgr.save(symbol=_mlp(tmx), arg_params=_torch_args(), epoch=1)
    _flip_bit(os.path.join(d, "m-0001.shard0.json"))  # sidecar: not read
    assert mgr.load(device="cpu").epoch == 1
    monkeypatch.setenv("MXNET_CKPT_VERIFY", "0")
    assert not tck.CheckpointManager(d, prefix="m").verify
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "1")
    assert tck.CheckpointManager(d, prefix="m").async_writes


# ---------------------------------------------------------------------------
# retention, stale shards, coverage
# ---------------------------------------------------------------------------

def test_gc_skips_corrupt_and_pinned(tmp_path):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m", keep=2)
    for e in (1, 2, 3):
        mgr.save(arg_params=_torch_args(e), epoch=e)
    assert mgr.epochs() == [2, 3]
    _flip_bit(os.path.join(d, "m-0003.shard0.params"))
    assert mgr.load(device="cpu").epoch == 2
    mgr.save(arg_params=_torch_args(4), epoch=4)
    mgr.save(arg_params=_torch_args(5), epoch=5)
    assert 2 in mgr.epochs() and mgr.epochs()[-2:] == [4, 5]
    assert any(n.startswith("m-0003.") and n.endswith(".corrupt")
               for n in os.listdir(d))


def test_gc_tolerates_concurrent_deletion(tmp_path, monkeypatch):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m", keep=1)
    mgr.save(arg_params=_torch_args(1), epoch=1)
    real_remove = os.remove

    def racing_remove(path):
        real_remove(path)
        raise FileNotFoundError(path)

    monkeypatch.setattr(os, "remove", racing_remove)
    mgr.save(arg_params=_torch_args(2), epoch=2)
    monkeypatch.setattr(os, "remove", real_remove)
    assert mgr.epochs() == [2]


def test_resave_smaller_topology_drops_stale_shards(tmp_path):
    d = str(tmp_path)
    stale = np.full((8, 8), 99.0, dtype="float32")
    spath = os.path.join(d, "m-0001.shard2.params")
    with open(spath, "wb") as f:
        np.savez(f, **{"arg:fc1_weight/0": stale})
    with open(os.path.join(d, "m-0001.shard2.json"), "w") as f:
        json.dump({"rank": 2, "file": "m-0001.shard2.params",
                   "sha256": hashlib.sha256(
                       open(spath, "rb").read()).hexdigest(),
                   "bytes": os.path.getsize(spath),
                   "pieces": {"arg:fc1_weight/0": {
                       "param": "arg:fc1_weight",
                       "index": [[0, 8], [0, 8]]}}}, f)
    args = _torch_args()
    mgr = tck.CheckpointManager(d, prefix="m")
    mgr.save(symbol=_mlp(tmx), arg_params=args, epoch=1)
    names = os.listdir(d)
    assert "m-0001.shard2.params" not in names
    assert "m-0001.shard2.json" not in names
    man = json.load(open(os.path.join(d, "m-0001.manifest.json")))
    assert [s["rank"] for s in man["shards"]] == [0]
    assert _bits(mgr.load(device="cpu").arg_params["fc1_weight"]) == \
        _bits(args["fc1_weight"])


def test_verify_rejects_overlapping_coverage(tmp_path):
    d = str(tmp_path)
    full = np.arange(16 * 4, dtype="float32").reshape(16, 4)
    shards_meta = []
    for rank, (lo, hi) in enumerate(((0, 10), (6, 16))):
        shard = os.path.join(d, "m-0001.shard%d.params" % rank)
        with open(shard, "wb") as f:
            np.savez(f, **{"arg:w/0": full[lo:hi]})
        shards_meta.append({
            "rank": rank, "file": os.path.basename(shard),
            "sha256": hashlib.sha256(open(shard, "rb").read()).hexdigest(),
            "bytes": os.path.getsize(shard),
            "pieces": {"arg:w/0": {"param": "arg:w",
                                   "index": [[lo, hi], [0, 4]]}}})
    with open(os.path.join(d, "m-0001.manifest.json"), "w") as f:
        json.dump({"format": 2, "epoch": 1, "nbatch": 0, "num_update": 0,
                   "have_states": False, "num_processes": 2,
                   "params": {"arg:w": {"shape": [16, 4],
                                        "dtype": "float32", "spec": None}},
                   "shards": shards_meta, "states": None}, f)
    mgr = tck.CheckpointManager(d, prefix="m")
    with pytest.raises(tck.CorruptCheckpoint, match="over-covered"):
        mgr.load(epoch=1, device="cpu")
    assert mgr.epochs() == []


# ---------------------------------------------------------------------------
# atomic writes and async writes
# ---------------------------------------------------------------------------

def test_atomic_replace_failure_preserves_original(tmp_path):
    path = str(tmp_path / "f.bin")
    tck.atomic_replace(path, lambda tmp: open(tmp, "w").write("v1")
                       and None)
    assert open(path).read() == "v1"

    def boom(tmp):
        with open(tmp, "w") as f:
            f.write("torn")
        raise OSError("disk gone")

    with pytest.raises(OSError):
        tck.atomic_replace(path, boom)
    assert open(path).read() == "v1"
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


@pytest.mark.chaos
def test_checkpoint_io_fault_leaves_previous_epoch(tmp_path, monkeypatch):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m")
    mgr.save(arg_params=_torch_args(1), epoch=1)
    monkeypatch.setenv("MXNET_FAULT_INJECT", "shard_write:raise")
    faults.reset()
    with pytest.raises(faults.FaultInjected):
        mgr.save(arg_params=_torch_args(2), epoch=2)
    assert mgr.epochs() == [1]
    assert not any(".tmp-" in n for n in os.listdir(d))


def test_async_save_equivalent_to_sync(tmp_path):
    args = _torch_args()
    sd, ad = str(tmp_path / "s"), str(tmp_path / "a")
    tck.CheckpointManager(sd, prefix="m").save(
        symbol=_mlp(tmx), arg_params=args, epoch=1)
    amgr = tck.CheckpointManager(ad, prefix="m", async_writes=True)
    amgr.save(symbol=_mlp(tmx), arg_params=args, epoch=1)
    amgr.flush()
    s1, s2 = _load(sd), _load(ad)
    for k in s1.arg_params:
        assert _bits(s1.arg_params[k]) == _bits(s2.arg_params[k])
    assert open(os.path.join(sd, "m-0001.shard0.params"), "rb").read() \
        == open(os.path.join(ad, "m-0001.shard0.params"), "rb").read()


def test_async_depth_one_and_error_surfacing(tmp_path, monkeypatch):
    mgr = tck.CheckpointManager(str(tmp_path), prefix="m",
                                async_writes=True)
    args = _torch_args()
    mgr.save(arg_params=args, epoch=1)
    mgr.save(arg_params=args, epoch=2)
    mgr.flush()
    assert mgr.epochs() == [1, 2]
    monkeypatch.setenv("MXNET_FAULT_INJECT", "shard_write:raise")
    faults.reset()
    mgr.save(arg_params=args, epoch=3)
    with pytest.raises(faults.FaultInjected):
        mgr.save(arg_params=args, epoch=4)
    monkeypatch.delenv("MXNET_FAULT_INJECT")
    faults.reset()
    mgr.save(arg_params=args, epoch=5)
    mgr.flush()
    assert 3 not in mgr.epochs() and 5 in mgr.epochs()


def test_async_join_timeout_raises_not_hangs(tmp_path, monkeypatch):
    mgr = tck.CheckpointManager(str(tmp_path), prefix="m",
                                async_writes=True)
    monkeypatch.setenv("MXNET_FAULT_INJECT", "shard_write:delay:seconds=1")
    monkeypatch.setenv("MXNET_CKPT_JOIN_TIMEOUT_S", "0.1")
    faults.reset()
    mgr.save(arg_params=_torch_args(), epoch=1)
    with pytest.raises(MXNetError, match="MXNET_CKPT_JOIN_TIMEOUT_S"):
        mgr.flush()
    monkeypatch.setenv("MXNET_CKPT_JOIN_TIMEOUT_S", "30")
    mgr.flush()
    assert mgr.epochs() == [1]


# ---------------------------------------------------------------------------
# resolve_resume, devices, and what waits for the multi-device layer
# ---------------------------------------------------------------------------

def test_resolve_resume_forms(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), prefix="m")
    mgr.save(symbol=_mlp(tmx), arg_params=_torch_args(), epoch=2)
    prefix = os.path.join(str(tmp_path), "m")
    for spec in (mgr, mgr.load(device="cpu"), prefix, (prefix, 2)):
        assert tck.resolve_resume(spec, device="cpu").epoch == 2
    with pytest.raises(MXNetError, match="resume_from"):
        tck.resolve_resume(1.5)


def test_load_defaults_to_the_card(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), prefix="m")
    mgr.save(arg_params=_torch_args(), epoch=1)
    if torch.cuda.is_available():
        assert mgr.load().arg_params["fc1_bias"]._data.is_cuda
    else:
        with pytest.raises(MXNetError, match="device='cpu'"):
            mgr.load()


@pytest.mark.parametrize("call", ["mesh", "sharding", "zero_states",
                                  "zero_params", "plan", "kvstore",
                                  "coordinator"])
def test_multi_device_arguments_are_a_later_slice(tmp_path, monkeypatch,
                                                  call):
    d = str(tmp_path)
    mgr = tck.CheckpointManager(d, prefix="m")
    mgr.save(arg_params=_torch_args(), epoch=1)
    with pytest.raises(MXNetError, match="later slice"):
        if call in ("mesh", "sharding"):
            mgr.load(device="cpu", **{call: "x"})
        elif call == "kvstore":
            tck.CheckpointManager(d, prefix="m", kvstore=object())
        elif call == "coordinator":
            monkeypatch.setenv("MXNET_COORDINATOR", "localhost:1234")
            mgr.save(arg_params=_torch_args(), epoch=2)
        else:
            mgr.save(arg_params=_torch_args(), epoch=2, **{call: {}})
