"""Generator ``table3``: the paper's Sec. 5.1 / Table 3 artificial
dataset (``reference.synthetic.generate_table3_db``); ``params`` are
``Table3Params``' fields."""
from typing import List

from bench_port.reference import synthetic
from bench_port.reference.graphseq import TRSeq


def generate(params: dict, seed: int) -> List[TRSeq]:
    return synthetic.generate_table3_db(synthetic.Table3Params(**params),
                                        seed=seed)
