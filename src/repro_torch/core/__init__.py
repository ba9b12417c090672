"""The paper's analysis layer (counterpart of ``repro.core``): the
FengHuang hardware constants (:mod:`.hw`, beside the H100's own), the
latency model of Table 3.1 and Eq. (3.1)-(4.1) (:mod:`.latency`), the
§3.3.3 speed-up decomposition (:mod:`.analysis`), the operator graphs of
the paper's workloads (:mod:`.graphs`) and the discrete-event simulator
behind Figure 4.1 and Table 4.3 (:mod:`.simulator`).  Plain Python
floats throughout; the simulator's local-memory formula is the live
ledger's (:mod:`repro_torch.memory.accounting`).
"""
