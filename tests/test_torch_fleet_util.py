"""The port's ``fleet.fs``, data generators and ``fleet.util`` in one
process, held to the JAX package's: ``LocalFS`` does the same file
operations with the same results and errors, ``HDFSClient`` raises
``ExecuteError`` without ``hadoop``, both data generators print the JAX
package's lines string for string, and ``UtilBase`` and the metrics
reduce over a world of one as the JAX package's do.  (Across processes:
``test_torch_multiprocess.py``.)"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import fs as jfs
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import fs as tfs

torch.set_num_threads(1)


def _fs_script(fs_mod, root):
    fs = fs_mod.LocalFS()
    out = []
    d = str(root / "a" / "b")
    fs.mkdirs(d)
    fs.touch(d + "/f1")
    fs.touch(d + "/f2")
    fs.mkdirs(d + "/sub")
    out.append(fs.ls_dir(d))
    out.append((fs.is_file(d + "/f1"), fs.is_dir(d + "/sub"),
                fs.is_exist(d + "/nope")))
    for call in (lambda: fs.touch(d + "/f1", exist_ok=False),
                 lambda: fs.mv(d + "/nope", d + "/x"),
                 lambda: fs.mv(d + "/f1", d + "/f2")):
        try:
            call()
            out.append("no error")
        except fs_mod.ExecuteError as e:
            out.append(type(e).__name__ + ": " + str(e).replace(
                str(root), "<root>"))
    fs.mv(d + "/f1", d + "/f2", overwrite=True)
    fs.upload(d + "/f2", d + "/up")
    fs.download(d + "/up", d + "/down")
    fs.delete(d + "/sub")
    out.append(fs.ls_dir(d))
    out.append(fs.ls_dir(str(root / "missing")))
    return out


def test_local_fs_matches_jax(tmp_path):
    assert _fs_script(tfs, tmp_path / "port") == \
        _fs_script(jfs, tmp_path / "jax")


@pytest.mark.parametrize("call", ["ls_dir", "mkdirs", "upload"])
def test_hdfs_client_raises_without_hadoop(call, tmp_path):
    args = {"ls_dir": ("/x",), "mkdirs": ("/x",), "upload": ("a", "b")}
    for mod in (tfs, jfs):
        client = mod.HDFSClient(hadoop_home=str(tmp_path / "no_hadoop"))
        with pytest.raises(mod.ExecuteError, match="hadoop"):
            getattr(client, call)(*args[call])
        assert client.is_exist("/x") is False


def _generated(pkg, kind, mode, lines=()):
    base = {"multi": pkg.MultiSlotDataGenerator,
            "string": pkg.MultiSlotStringDataGenerator}[kind]

    class Gen(base):
        def generate_sample(self, line):
            def it():
                if line is None:
                    for i in range(7):
                        vals = [i, i * 2] if kind == "multi" else \
                            [f"w{i}", f"v{i * 2}"]
                        yield [("words", vals), ("label", vals[:1])]
                else:
                    toks = line.split()
                    yield [("words", toks if kind == "string"
                            else [int(t) for t in toks]),
                           ("label", toks[:1])]
            return it

    gen = Gen()
    gen.set_batch(3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mode == "memory":
            gen.run_from_memory()
        else:
            old = sys.stdin
            sys.stdin = io.StringIO("".join(f"{ln}\n" for ln in lines))
            try:
                gen.run_from_stdin()
            finally:
                sys.stdin = old
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["multi", "string"])
@pytest.mark.parametrize("mode", ["memory", "stdin"])
def test_data_generators_match_jax(kind, mode):
    lines = ["1 2 3", "4 5", "6", "7 8 9 10"]
    got = _generated(tfleet, kind, mode, lines)
    assert got and got == _generated(jfleet, kind, mode, lines)


def test_generator_refuses_bad_samples():
    for pkg in (tfleet, jfleet):
        with pytest.raises(ValueError):
            pkg.MultiSlotDataGenerator()._gen_str("not a list")
        with pytest.raises(NotImplementedError):
            pkg.DataGenerator().generate_sample(None)


def test_util_and_metrics_alone_match_jax():
    files = [f"part-{i}" for i in range(5)]
    for pkg in (tfleet, jfleet):
        u = pkg.util
        assert isinstance(u, pkg.UtilBase)
        np.testing.assert_array_equal(u.all_reduce(np.arange(3), "max"),
                                      np.arange(3))
        assert u.all_gather({"a": 1}) == [{"a": 1}]
        assert u.get_file_shard(files) == files
        u.barrier()
    vals = np.array([0.2, 0.5, 0.9])
    pos, neg = np.array([1.0, 3.0, 5.0]), np.array([4.0, 2.0, 1.0])
    for name, args in (("sum", (vals,)), ("max", (vals,)), ("min", (vals,)),
                       ("acc", (7, 10)), ("mae", (vals, 3)),
                       ("rmse", (vals, 3)), ("mse", (vals, 3)),
                       ("auc", (pos, neg))):
        got = getattr(tfleet.metrics, name)(*args)
        want = getattr(jfleet.metrics, name)(*args)
        assert np.asarray(got) == pytest.approx(np.asarray(want)), name
