"""The paper's own technique: the PIM system description
(``pim_arch``), PIMnast placement (``placement``: Algorithms 1-3, split-K
and Fig. 6's placement space) and the OPT workload suite
(``opt_models``).  The port's copies of ``repro.core``: the analytical
code is the same plain Python; the three array functions of
``placement`` take and return tensors."""
