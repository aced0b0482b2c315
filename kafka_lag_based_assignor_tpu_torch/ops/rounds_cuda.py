"""The greedy round scan: the hand-written CUDA kernel, its wrapper and its
plain PyTorch version.

Counterpart of ``kafka_lag_based_assignor_tpu/ops/rounds_pallas.py``: the
kernel in ``csrc/rounds_scan.cu`` replaces the TPU kernels
``_rounds_kernel`` (int32 totals) and ``_rounds_kernel_wide`` (int64 totals
as two int32 planes).  It is one int64 kernel in three forms, picked in the
CUDA source from the slot count N = next_pow2(C) (:func:`slots_for`):

* registers, up to :data:`REGISTER_SLOTS` (16,384) slots: one thread block
  a topic, every consumer's slot in its registers across the rounds; bound
  by the network's depth, a shuffle or a block barrier a stage;
* cluster, up to :data:`CLUSTER_SLOTS` (131,072) slots: one thread-block
  cluster of 16 blocks a topic, each block's share of the slots in its
  registers and the long strides through distributed shared memory; bound
  by the same depth, a cluster barrier for each of the 10 cross-block
  stages of a round;
* scratch, above: one block a topic, its slots in device scratch
  (:func:`wide_scratch`); bound by one SM's throughput over that scratch.

Every form takes any consumer count, as the JAX package does.

It has two key forms, chosen per call from the input's range as the JAX
package chooses its round body (``totals_rank_bits_for``): the packed int64
key ``(total << rank_bits) | id`` (``ops/rounds_kernel.py::
_rounds_body_packed``) where :func:`packed_rank_bits` admits it, else the
two-key (total, id) network (``_rounds_body``).  Both give the same bits.

:func:`rounds_scan` is the wrapper.  A CUDA tensor launches the kernel or
raises; a CPU tensor runs :func:`rounds_scan_torch`, the plain version, in
the same key form.  Both accept the same inputs and raise on the same ones,
so the CPU and the card never disagree about what is admissible.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import count_launch

#: Most slots the register network holds (16 a thread over 1,024 threads,
#: whose two-key exchange buffer, 12 B a slot, is 192 KiB of shared memory);
#: above it K1 and K7 sort on a thread-block cluster.
REGISTER_SLOTS = 16384
#: Most slots the cluster form holds (``kMaxClusterSlots`` in
#: ``csrc/slot_sort.cuh``: 16 blocks of 8,192); above it K1 and K7 sort in
#: their scratch form, the slots in device scratch, which the wrapper sizes.
CLUSTER_SLOTS = 131072
#: Bytes of a slot in the scratch form: an int64 key, an int32 id.
_WIDE_SLOT_BYTES = 12
_INT64_MAX = torch.iinfo(torch.int64).max


def slots_for(num_consumers: int) -> int:
    """next_pow2(C): the kernel's slot count for C consumers."""
    return 1 << max(int(num_consumers) - 1, 0).bit_length()


def _check(gains, valid, totals0, carry_across_topics: bool) -> tuple:
    """Raise on what the kernel does not take; return (bound, low): the
    largest total any slot can reach (f64, an int64 sum could wrap) and the
    least valid gain or starting total, from one host read."""
    if gains.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rounds_scan runs on cuda or cpu, not {gains.device}")
    if gains.dim() != 3 or gains.dtype != torch.int64:
        raise ValueError(f"gains must be int64[T, R, C], got {gains.dtype}"
                         f"{list(gains.shape)}")
    if valid.dtype != torch.uint8 or valid.shape != gains.shape:
        raise ValueError(f"valid must be uint8{list(gains.shape)}, got "
                         f"{valid.dtype}{list(valid.shape)}")
    C = gains.shape[2]
    if totals0.dtype != torch.int64 or tuple(totals0.shape) != (C,):
        raise ValueError(f"totals0 must be int64[{C}], got {totals0.dtype}"
                         f"{list(totals0.shape)}")
    if not (gains.device == valid.device == totals0.device):
        raise ValueError("gains, valid and totals0 must be on one device")
    if not (gains.is_contiguous() and valid.is_contiguous()
            and totals0.is_contiguous()):
        raise ValueError("gains, valid and totals0 must be contiguous")
    if C < 1:
        raise ValueError("the round scan needs at least one consumer")
    f64 = torch.float64
    if gains.numel():
        live = torch.where(valid.bool(), gains, 0)
        low = live.amin().to(f64)
        # One f64 copy, its abs in place (the linear solve's greedy start
        # runs this beside the rounding tail's [P] buffers).
        per_topic = live.to(f64)
        del live
        per_topic.abs_()
        sums = per_topic.sum() if carry_across_topics else per_topic.sum(dim=(1, 2)).amax()
    else:
        sums = low = torch.zeros((), dtype=f64, device=gains.device)
    start = totals0.to(f64)
    sums, start_abs, low, start_low = torch.stack(
        [sums, start.abs().amax(), low, start.amin()]).tolist()
    # It must stay below the INT64_MAX sentinel of the pad slots.
    bound = sums + start_abs
    if bound >= float(_INT64_MAX):
        raise ValueError(
            f"total lag up to {bound:.6g} could reach the int64 sentinel "
            f"(2**63 - 1) of the round scan"
        )
    return bound, min(low, start_low)


def packed_rank_bits(gains, valid, totals0, carry_across_topics: bool = False) -> int:
    """The key form a call takes: rank_bits = max(1, bit_length(C - 1)) when
    every valid gain and every ``totals0`` entry is >= 0 and the largest
    total a slot can reach (each topic's valid gains, or with
    ``carry_across_topics`` all topics', plus max |totals0|) is below
    2^(61 - rank_bits), so that ``(total << rank_bits) | id`` fits an int64
    with room to spare; else 0, the two-key form.  The port's copy of
    ``ops/batched.totals_rank_bits_for``'s rule, which also counts the
    starting totals.  Raises where :func:`rounds_scan` does."""
    bound, low = _check(gains, valid, totals0, carry_across_topics)
    return rank_bits_for(gains.shape[-1], bound, low)


def rank_bits_for(num_consumers: int, bound: float, low: float) -> int:
    """rank_bits = max(1, bit_length(C - 1)) where ``low`` (the least gain
    or starting total) is >= 0 and ``bound`` (the largest total a slot can
    reach) is below 2^(61 - rank_bits), else 0 (the two-key form)."""
    rank_bits = max(1, (int(num_consumers) - 1).bit_length())
    return rank_bits if low >= 0 and bound < float(1 << (61 - rank_bits)) else 0


def rounds_scan_torch(gains, valid, totals0, carry_across_topics: bool = False,
                      rank_bits: int = 0):
    """Plain PyTorch version of the kernel, in either key form.

    ``rank_bits`` 0 runs the ``_rounds_body`` loop: each round sorts the
    totals stably (ties break by consumer id, the index order), seats
    ``order[j]`` at position j (-1 where invalid) and adds the valid gains
    to the seated consumers.  ``rank_bits`` > 0 (as :func:`packed_rank_bits`
    gives it) runs the ``_rounds_body_packed`` loop over the kernel's
    next_pow2(C) slots: it sorts the packed keys, with the pad slots' key
    above every real one, reads the ids from the low bits and adds the
    gains positionally.  Returns (choice int32[T, R, C], totals int64[T,
    C], or [1, C] when carrying the totals across topics).
    """
    T, R, C = gains.shape
    if carry_across_topics:
        gains, valid = gains.reshape(1, T * R, C), valid.reshape(1, T * R, C)
    if rank_bits:
        choice, totals = _packed_rounds(gains, valid, totals0, rank_bits)
        return choice.reshape(T, R, C), totals
    n_blocks, n_rounds = gains.shape[0], gains.shape[1]
    totals = totals0.expand(n_blocks, C).clone()
    choice = torch.empty(gains.shape, dtype=torch.int32, device=gains.device)
    for r in range(n_rounds):
        _, order = torch.sort(totals, dim=1, stable=True)
        v = valid[:, r].bool()
        choice[:, r] = torch.where(v, order.to(torch.int32), -1)
        totals.scatter_add_(1, order, torch.where(v, gains[:, r], 0))
    return choice.reshape(T, R, C), totals


def _packed_rounds(gains, valid, totals0, rank_bits: int):
    n_blocks, n_rounds, C = gains.shape
    ids = torch.arange(slots_for(C), dtype=torch.int64, device=gains.device)
    pad = ((_INT64_MAX >> rank_bits) << rank_bits) | ids[C:]
    keys = torch.cat([(totals0 << rank_bits) | ids[:C], pad]).expand(n_blocks, -1)
    id_mask = (1 << rank_bits) - 1
    choice = torch.empty(gains.shape, dtype=torch.int32, device=gains.device)
    for r in range(n_rounds):
        keys = torch.sort(keys, dim=1).values
        v = valid[:, r].bool()
        choice[:, r] = torch.where(v, keys[:, :C] & id_mask, -1).to(torch.int32)
        keys[:, :C] += torch.where(v, gains[:, r], 0) << rank_bits
    real = keys[:, :C]  # the pad slots sort after every real one
    totals = torch.empty((n_blocks, C), dtype=torch.int64, device=gains.device)
    return choice, totals.scatter_(1, real & id_mask, real >> rank_bits)


def wide_scratch(blocks: int, slots: int, device):
    """The scratch form's scratch for ``blocks`` blocks of ``slots`` slots
    (int64 keys, then int32 ids), or None at or below
    :data:`CLUSTER_SLOTS` slots, where the kernel keeps its slots in
    registers (of one block or of a cluster's).  The kernel writes every
    slot before it reads it."""
    if slots <= CLUSTER_SLOTS:
        return None
    return torch.empty(blocks * slots * _WIDE_SLOT_BYTES, dtype=torch.uint8, device=device)


def _bind():
    from ._build import load

    lib = load("rounds_scan")
    fn = lib.klba_rounds_scan
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.klba_rounds_scan_vector_io.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.klba_rounds_scan_vector_io.restype = ctypes.c_int
    lib.klba_cuda_error_string.argtypes = [ctypes.c_int]
    lib.klba_cuda_error_string.restype = ctypes.c_char_p
    return lib


def vector_io(gains, valid, choice) -> bool:
    """Whether the kernel, given these CUDA tensors (``choice`` as a launch
    returned it), moved its rows with 16-byte loads and stores (C a multiple
    of the slots a thread, the rows aligned) rather than a slot at a time."""
    C = gains.shape[2]
    got = _bind().klba_rounds_scan_vector_io(
        gains.data_ptr(), valid.data_ptr(), choice.data_ptr(), C, slots_for(C))
    if got < 0:
        raise ValueError(f"no round-scan kernel for {C} consumers")
    return bool(got)


def _launch(gains, valid, totals0, carry_across_topics: bool, rank_bits: int):
    T, R, C = gains.shape
    n_blocks, n_rounds = (1, T * R) if carry_across_topics else (T, R)
    choice = torch.empty(gains.shape, dtype=torch.int32, device=gains.device)
    totals = torch.empty((n_blocks, C), dtype=torch.int64, device=gains.device)
    if n_blocks == 0:
        return choice, totals
    lib = _bind()
    scratch = wide_scratch(n_blocks, slots_for(C), gains.device)
    with torch.cuda.device(gains.device):
        err = lib.klba_rounds_scan(
            gains.data_ptr(), valid.data_ptr(), totals0.data_ptr(),
            choice.data_ptr(), totals.data_ptr(),
            n_blocks, n_rounds, C, slots_for(C), rank_bits,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(gains.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "rounds_scan kernel launch failed: "
            + lib.klba_cuda_error_string(err).decode()
        )
    count_launch(rounds_scan)
    return choice, totals


def rounds_scan(gains, valid, totals0, carry_across_topics: bool = False):
    """The greedy round scan over pre-rounded rows.

    Args:
      gains: int64[T, R, C] — round r's sorted lags of topic t (from
        :func:`..ops.rounds_kernel.round_rows`).
      valid: uint8[T, R, C] — their validity (0 = padding position).
      totals0: int64[C] — every topic's starting per-consumer totals.
      carry_across_topics: run the T*R rounds as one sequence with the
        totals carried from topic to topic (the ``global`` solver).

    Returns (choice int32[T, R, C]: consumer seated at each position, -1
    where invalid; totals int64[T, C] in consumer order, or [1, C] when
    carrying).  The key form is :func:`packed_rank_bits`'s, on both
    devices.  A CUDA tensor launches the kernel (and counts the launch in
    ``rounds_scan.launches``) or raises; a CPU tensor runs
    :func:`rounds_scan_torch`.
    """
    rank_bits = packed_rank_bits(gains, valid, totals0, carry_across_topics)
    if gains.device.type == "cpu":
        return rounds_scan_torch(gains, valid, totals0, carry_across_topics, rank_bits)
    return _launch(gains, valid, totals0, carry_across_topics, rank_bits)


rounds_scan.launches = 0
