"""NN inference models as torch modules: the bonito basecaller and the
Clair variant caller (the port's copies of genomicsbench_palisade_tpu/models)."""
