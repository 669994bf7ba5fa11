"""`python -m maxk_tpu_torch.bench`: the one-line kernel benchmark record
(`bench/bench.py`)."""

from maxk_tpu_torch.bench.bench import main

if __name__ == "__main__":
    main()
