"""The port's fleet executor (``paddle_tpu_torch.distributed.fleet_executor``)
against the reference's, on the CPU.

The same task graphs run through both: every stage's run order, the
payloads that reach the sink and the credit-based flow control (a stage's
step k only after its upstream's step k, never more than the buffer ahead)
agree; source, compute and sink interceptors by node type; an error inside
a stage reaches ``run``; a carrier that does not finish raises. For the
slice as a whole, a tiny GPT split into two stages (the embedding and the
first block; the second block, the final norm and the LM loss) runs four
microbatches through source, compute and sink interceptors of each
package, from one state_dict: the port's losses equal its unsplit forward
bit for bit and the reference's within 1e-5.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.distributed.fleet_executor as P_fe
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed.fleet_executor as T_fe
from paddle_tpu.models.gpt import GPTConfig as P_GPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as P_GPT
from paddle_tpu_torch._testing import share_the_cores_fixture
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")


def _chain(fe, n_micro, credit, log):
    """A 3-stage chain a -> b -> c; each stage logs (name, step) and the
    payload grows by one a stage."""
    def stage(name):
        def program(step, inputs):
            log.append((name, step))
            val = list(inputs.values())[0] if inputs else step * 10
            return val + 1
        return program

    nodes = [fe.TaskNode(task_id=i, max_run_times=n_micro,
                         program=stage(name))
             for i, name in enumerate("abc")]
    for up, down in ((0, 1), (1, 2)):
        nodes[up].add_downstream_task(down, credit)
        nodes[down].add_upstream_task(up, credit)
    return nodes


@pytest.mark.parametrize("n_micro,credit", [(4, 2), (5, 1)])
def test_chain_runs_as_the_reference(n_micro, credit):
    runs = []
    for fe in (P_fe, T_fe):
        log, out = [], []
        nodes = _chain(fe, n_micro, credit, log)
        sink = nodes[2].program
        nodes[2].program = lambda s, i, sink=sink: out.append(sink(s, i))
        ex = fe.FleetExecutor()
        ex.init(0, nodes)
        ex.run(timeout=30)
        ex.stop()
        runs.append((log, out))
    (ref_log, ref_out), (log, out) = runs
    assert out == ref_out == [k * 10 + 3 for k in range(n_micro)]
    for name in "abc":
        assert [s for n, s in log if n == name] == list(range(n_micro))
    for k in range(n_micro):
        assert log.index(("a", k)) < log.index(("b", k)) < \
            log.index(("c", k))
        # credit: a runs at most `credit` steps ahead of b's release
        if k + credit < n_micro:
            assert log.index(("a", k + credit)) > log.index(("b", k))


def test_node_types_pick_source_compute_and_sink():
    seen = []
    nodes = [T_fe.TaskNode(task_id=i, max_run_times=2, node_type=kind,
                           program=lambda s, inp: seen.append(s) or s)
             for i, kind in enumerate(("Source", "Compute", "Sink"))]
    nodes[0].add_downstream_task(1)
    nodes[1].add_upstream_task(0)
    nodes[1].add_downstream_task(2)
    nodes[2].add_upstream_task(1)
    ex = T_fe.FleetExecutor()
    car = ex.init(0, nodes)
    kinds = [type(car._interceptors[i]) for i in range(3)]
    assert kinds == [T_fe.SourceInterceptor, T_fe.ComputeInterceptor,
                     T_fe.SinkInterceptor]
    ex.run(timeout=30)
    ex.stop()
    assert sorted(seen) == [0, 0, 0, 1, 1, 1]


def test_cross_carrier_bus_and_errors():
    got = []
    a = T_fe.TaskNode(rank=0, task_id=0, max_run_times=3,
                      program=lambda s, i: np.float32(s + 0.5))
    b = T_fe.TaskNode(rank=1, task_id=1, max_run_times=3,
                      program=lambda s, i: got.append(float(i[0])))
    a.add_downstream_task(1, 1)
    b.add_upstream_task(0, 1)
    ex = T_fe.FleetExecutor()
    ex.init(0, [a])
    ex.init(1, [b])
    ex.run(timeout=30)
    ex.stop()
    assert got == [0.5, 1.5, 2.5]

    def bad(step, inputs):
        raise ValueError("boom")
    ex = T_fe.FleetExecutor()
    ex.init(0, [T_fe.TaskNode(task_id=0, program=bad)])
    with pytest.raises(ValueError, match="boom"):
        ex.run(timeout=10)
    ex.stop()


def test_a_carrier_that_does_not_finish_raises():
    """An upstream that never runs leaves its downstream waiting: run
    raises at its timeout, where the reference's returns."""
    a = T_fe.TaskNode(task_id=0, max_run_times=1)
    a.add_upstream_task(9)                  # nothing sends from 9
    ex = T_fe.FleetExecutor()
    ex.init(0, [a])
    with pytest.raises(TimeoutError):
        ex.run(timeout=0.3)
    ex.stop()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_split(paddle, fe, model, micro):
    """The microbatches through source (stage 0), compute (stage 1) and
    sink (collects the losses) interceptors."""
    # phase 20d's two programs (the unsplit forward cut in two), held
    # here against the reference's model cut the same way
    stage0, stage1 = _chip_smoke()._gpt_stages(paddle, model, 1)
    losses = []
    nodes = [
        fe.TaskNode(task_id=0, max_run_times=len(micro), node_type="Source",
                    program=lambda s, i: (stage0(micro[s]), micro[s])),
        fe.TaskNode(task_id=1, max_run_times=len(micro),
                    program=lambda s, i: stage1(*i[0])),
        fe.TaskNode(task_id=2, max_run_times=len(micro), node_type="Sink",
                    program=lambda s, i: losses.append(float(i[1]))),
    ]
    for up, down in ((0, 1), (1, 2)):
        nodes[up].add_downstream_task(down, 2)
        nodes[down].add_upstream_task(up, 2)
    ex = fe.FleetExecutor()
    ex.init(0, nodes)
    ex.run(timeout=60)
    ex.stop()
    return losses


def test_two_stage_gpt_equals_the_unsplit_forward_and_the_reference():
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=64)
    T.seed(0)
    port = GPTForCausalLM(GPTConfig(**cfg))
    port.eval()
    ref = P_GPT(P_GPTConfig(**cfg))
    ref.set_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    ref.eval()
    ids = np.random.RandomState(0).randint(0, 256, (4, 1, 32))
    micro = [T.to_tensor(m) for m in ids]
    with T.no_grad():
        losses = _run_split(T, T_fe, port, micro)
        whole = [float(port(m, m)) for m in micro]
    assert losses == whole
    ref_losses = _run_split(P, P_fe, ref, [P.to_tensor(m) for m in ids])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
