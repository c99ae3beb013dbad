"""End-to-end HPO sweep driver: the canonical use of the port.

Counterpart of ``examples/lm_sweep/driver.py``, with its flags and steps:

1. register the default techniques in the library,
2. build one Task per batch size,
3. ``search``: profile every (task x block size x technique),
4. clone each searched task across the other learning rates without
   profiling again (lr does not change the step time),
5. ``orchestrate``: solve and run every task to completion,

then print each task's trained steps. By default it trains on the bundled
real-text corpus (``examples/data/corpus.txt``) through the native word
tokenizer. It runs on the card, or on the host's CPU with ``--platform
cpu`` (one device there; the CPU mode of the JAX package's ``driver.py``
is 8 virtual XLA devices).

    python -m saturn_tpu_torch.examples.lm_sweep --preset gpt2-small --lrs 1e-4 3e-4
    python -m saturn_tpu_torch.examples.lm_sweep --preset test-tiny --platform cpu --batch-count 8
"""

from __future__ import annotations

import argparse
import os
import time

_BUNDLED_CORPUS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "data", "corpus.txt"
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="test-tiny",
                   help="model preset (test-tiny, gpt2-small, gptj-test-tiny, ...)")
    p.add_argument("--context-length", type=int, default=None,
                   help="sequence length (default: the preset's)")
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[8],
                   help="one task per batch size")
    p.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 1e-4],
                   help="lr variants cloned from each searched task")
    p.add_argument("--batch-count", type=int, default=16, help="batches per task")
    p.add_argument("--interval", type=float, default=60.0,
                   help="scheduling interval seconds")
    p.add_argument("--techniques", nargs="+", default=None,
                   help="library names to profile (default: all registered)")
    p.add_argument("--chip-range", type=int, nargs="+", default=None,
                   help="block sizes to profile (default: every power of two)")
    p.add_argument("--corpus", default=_BUNDLED_CORPUS,
                   help="local text file to tokenize; 'synthetic' for the "
                        "deterministic Zipf stream (default: the bundled "
                        "examples/data/corpus.txt)")
    p.add_argument("--tokenizer", choices=["word", "byte"], default="word",
                   help="corpus tokenizer (native word vocab, or raw bytes)")
    p.add_argument("--save-dir", default="saturn_sweep_ckpts")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="cpu = the host's CPU as one device (no card needed)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the sweep; returns its tasks."""
    args = parse_args(argv)

    import torch

    import saturn_tpu_torch as sat
    from saturn_tpu_torch import HParams, Task, library
    from saturn_tpu_torch.core.mesh import SliceTopology
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.gpt2 import build_gpt2, config_for
    from saturn_tpu_torch.models.loss import pretraining_loss
    from saturn_tpu_torch.utils import checkpoint as ckpt

    topology = (SliceTopology([torch.device("cpu")]) if args.platform == "cpu"
                else SliceTopology())

    # 1) register techniques
    names = library.register_default_library()
    print(f"registered techniques: {names}")

    ctx = args.context_length or config_for(args.preset).seq_len
    vocab = config_for(args.preset).vocab_size
    corpus = None if args.corpus in ("synthetic", "none") else args.corpus
    if corpus and not os.path.exists(corpus):
        raise SystemExit(f"corpus file not found: {corpus}")
    print(f"corpus: {corpus or 'synthetic'} (tokenizer={args.tokenizer})")

    # 2) one task per batch size
    base_tasks = []
    for bs in args.batch_sizes:
        base_tasks.append(Task(
            get_model=lambda **kw: build_gpt2(args.preset, seq_len=ctx, **kw),
            get_dataloader=lambda bs=bs: make_lm_dataset(
                context_length=ctx, batch_size=bs, vocab_size=vocab,
                n_tokens=ctx * bs * max(args.batch_count, 16),
                corpus_path=corpus, tokenizer=args.tokenizer,
            ),
            loss_fn=pretraining_loss,
            hparams=HParams(lr=args.lrs[0], batch_count=args.batch_count),
            chip_range=args.chip_range,
            name=f"{args.preset}-bs{bs}-lr{args.lrs[0]:g}",
            save_dir=args.save_dir,
        ))

    # 3) profile
    t0 = time.time()
    sat.search(base_tasks, technique_names=args.techniques, log=True, topology=topology)
    print(f"search took {time.time() - t0:.1f}s")

    # 4) lr variants reuse the profile
    tasks = list(base_tasks)
    for task in base_tasks:
        for lr in args.lrs[1:]:
            tasks.append(task.clone(name=task.name.rsplit("-lr", 1)[0] + f"-lr{lr:g}", lr=lr))
    for t in tasks:
        feas = {g: f"{s.runtime:.1f}s/{s.executor.name}"
                for g, s in t.feasible_strategies().items()}
        print(f"  {t.name}: {feas}")

    # 5) solve + execute
    t0 = time.time()
    sat.orchestrate(tasks, log=True, interval=args.interval, topology=topology)
    print(f"orchestration took {time.time() - t0:.1f}s for {len(tasks)} tasks")

    for t in tasks:
        print(f"  {t.name}: trained steps={ckpt.saved_step(t.ckpt_path)} "
              f"remaining={t.total_batches}")
    return tasks


if __name__ == "__main__":
    main()
