"""The PyTorch port's variant-range shards
(``saigegds_tpu_torch/parallel/distributed.py``) on the CPU, against the
port's one-shot scan and the JAX package's shards.

Tolerances: ``host_variant_range`` -- the JAX function's ranges exactly;
the shards of ``assoc_spa_sharded`` merged by ``merge_shards`` -- the
one-shot ``assoc_spa`` table bit for bit (a variant's statistics do not
depend on the block or SPA batch it lands in), and the JAX package's
merged shards within 1e-10; the same through two processes in a gloo
process group.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_synth import one_torch_thread  # noqa: F401 (autouse)
from _torch_synth import jax_null_model, synth_codes, synth_pheno, \
    var_ratio_table
import saigegds_tpu
import saigegds_tpu_torch as sgt
from saigegds_tpu.io.gds_write import write_seqarray_gds
from saigegds_tpu_torch.parallel.distributed import assoc_spa_sharded, \
    host_variant_range, init_distributed, merge_shards, shard_path

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
RTOL_P = 1e-10
N_SAMPLES, N_VARIANTS, BLOCK = 1031, 300, 64
ALL_HET_ID = 3


@pytest.mark.parametrize("n", [0, 1, 7, 10, 100, 1001, 4096])
def test_host_variant_range_matches_jax(n):
    from saigegds_tpu.parallel.distributed import \
        host_variant_range as jax_range
    for cnt in range(1, 8):
        for pid in range(cnt + 1):
            assert host_variant_range(n, pid, cnt) == jax_range(n, pid, cnt)
    # outside a process group: this process is the only one
    assert host_variant_range(n) == (0, n)


def test_init_distributed_alone():
    assert init_distributed() == (0, 1)
    assert init_distributed(num_processes=1) == (0, 1)
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2, process_id=0, device="cpu")


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_distributed")
    rng = np.random.default_rng(43)
    X, y = synth_pheno(rng, N_SAMPLES)
    codes = synth_codes(rng, N_VARIANTS, N_SAMPLES, y=y)
    gds = str(tmp / "geno.gds")
    write_seqarray_gds(gds, codes)
    jm = jax_null_model(X, y, var_ratio_table("pooled"))
    tm = sgt.NullModel.from_arrays(vars(jm))
    model = str(tmp / "model.npz")
    tm.save(model)
    cfg = sgt.ScanConfig(block_size=BLOCK)
    inst = {}
    full = sgt.assoc_spa(gds, tm, cfg, instrument=inst, device="cpu")
    assert inst["spa_n"] > 0
    return dict(tmp=tmp, gds=gds, jm=jm, tm=tm, model=model, cfg=cfg,
                full=full)


def _assert_bit_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for c in a:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


@pytest.mark.parametrize("count", [3, 5])
def test_shards_merge_to_the_one_shot_table(scan, count):
    prefix = str(scan["tmp"] / f"scan{count}")
    paths = [assoc_spa_sharded(scan["gds"], scan["tm"], prefix, scan["cfg"],
                               process_id=pid, process_count=count,
                               device="cpu") for pid in range(count)]
    assert paths == [shard_path(prefix, pid) for pid in range(count)]
    assert paths[1].endswith(".part0001.rds")
    merged = merge_shards(prefix)
    _assert_bit_equal(merged, scan["full"])
    cols = merge_shards(prefix, columns=["id", "pval"])
    assert list(cols) == ["id", "pval"]
    if count == 3:
        from saigegds_tpu.parallel.distributed import \
            assoc_spa_sharded as jax_sharded, merge_shards as jax_merge
        jprefix = str(scan["tmp"] / "jax")
        for pid in range(count):
            jax_sharded(scan["gds"], scan["jm"], jprefix,
                        saigegds_tpu.ScanConfig(block_size=BLOCK,
                                                packed_sparse=False),
                        process_id=pid, process_count=count)
        want = jax_merge(jprefix)
        np.testing.assert_array_equal(merged["id"], want["id"].to_numpy())
        ok = merged["id"] != ALL_HET_ID   # round-off in both packages
        for c in ("pval", "p.norm", "beta", "SE"):
            np.testing.assert_allclose(merged[c][ok], want[c].to_numpy()[ok],
                                       rtol=RTOL_P, err_msg=c)


def test_merge_shards_needs_shards(tmp_path):
    with pytest.raises(FileNotFoundError, match="no shards"):
        merge_shards(str(tmp_path / "nothing"))


_TWO_PROCESSES = r"""
import sys
import torch.multiprocessing as mp


def worker(rank, init, gds, model, prefix):
    import torch
    import torch.distributed as dist
    import saigegds_tpu_torch as sg
    from saigegds_tpu_torch.parallel.distributed import \
        assoc_spa_sharded, host_variant_range, init_distributed
    torch.set_num_threads(1)
    assert init_distributed(init, 2, rank, device="cpu",
                            timeout_s=120) == (rank, 2)
    assert host_variant_range(300) == ((0, 150), (150, 300))[rank]
    assoc_spa_sharded(gds, model, prefix, sg.ScanConfig(block_size=64),
                      device="cpu")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=tuple(sys.argv[1:5]), nprocs=2, join=True)
    print("OK")
"""


def test_two_processes_in_a_gloo_group(scan):
    """``init_distributed`` + ``assoc_spa_sharded`` in two processes of a
    gloo group (``file://`` rendezvous): each takes its rank's range, and
    the merged shards equal the one-shot table."""
    tmp = scan["tmp"]
    script = tmp / "two_processes.py"
    script.write_text(_TWO_PROCESSES)
    prefix = str(tmp / "gloo")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), f"file://{tmp}/rendezvous",
         scan["gds"], scan["model"], prefix],
        cwd=str(tmp), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    _assert_bit_equal(merge_shards(prefix), scan["full"])
