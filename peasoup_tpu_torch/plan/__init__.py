from .dm_plan import generate_dm_list, delay_table, max_delay_samples, DMPlan
from .accel_plan import AccelerationPlan
from .fft_plan import prev_power_of_two, choose_fft_size
from .search_plan import SearchPlan, from_arrays
