from repro_torch.network.traces import BandwidthTrace, synth_4g_trace
from repro_torch.network.latency import comm_latency
