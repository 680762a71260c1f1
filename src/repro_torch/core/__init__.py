from repro_torch.core.slo import Request, Decision
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.solver import solve_bruteforce, solve_pruned
from repro_torch.core.queueing import EDFQueue, DynamicBatcher
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.vertical import VerticalScaledInstance
