"""The launcher: the port of ``paddle_tpu/distributed/launch`` (reference:
python -m paddle.distributed.launch, launch/main.py:23).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node N
[--master host:port] script.py args...`` starts N worker processes of this
host, one per GPU (or N CPU ranks when the script asks for the CPU), each
with the reference's variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, ...) and torch's (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so
``init_parallel_env`` joins them into one job.
"""
from .main import main  # noqa: F401
