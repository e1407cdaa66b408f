"""World constants of the merging game.

Frozen copy of ``core/constants.py`` of ``merging_gym_tpu_torch`` at
commit 79f5ae92604b, with its imports of the port replaced by the copies
in this folder. Nothing here imports the port or JAX.
"""

import math

# --- Lane geometry (merging_env.py:22-24, 34-37) ---------------------------
R = 30000.0          # arc radius of the two converging lanes [m]
H = 1000.0           # canvas height == longitudinal extent [m]
W = 300.0            # canvas width  == lateral extent [m]
START_POINT = 50.0   # longitudinal start position (merging_env.py:36)
END_POINT = H - 50.0  # merge / finish line at 950 (merging_env.py:37)

# Angle of the arc at longitudinal position 0 (merging_env.py:49).
ANGLE0 = math.atan2(H, R)

# --- Time discretisation (merging_env.py:25, 141-143) -----------------------
DT = 0.2             # integration step [s]
TIME_LIMIT = 500.0   # episode wall-clock limit [s]
# The reference accumulates `time_stamp += 0.2` in float64 and ends the
# episode once `time_stamp > 500`; the float sum first exceeds 500.0 on
# step 2501, so an integer step counter with this threshold is exact.
TIMEOUT_STEPS = 2501

# --- Rewards (merging_env.py:27-32) ----------------------------------------
R_FIRST = 2.0        # bonus for crossing the merge point first
R_SECOND = 1.0       # bonus for crossing second (also ends the episode)
R_COLLISION = -10.0  # both players, episode ends
VEL_PENALTY = 0.001  # per-step penalty weight on |v - V_REF|
TIME_PENALTY = 0.0
V_REF = 20.0         # reference velocity for the tracking penalty

# --- Vehicles (merging_env.py:39-40) ---------------------------------------
VEHICLE_W = 4.0      # lateral footprint  (pygame surface width)
VEHICLE_H = 8.0      # longitudinal footprint (pygame surface height)

# --- Control (merging_env.py:42-43, 100-101) -------------------------------
PREDICTION_T = 3.0   # MPC horizon [s]
TARGET_VELS = (0.0, 10.0, 20.0, 30.0, 40.0)  # action -> target velocity map
NUM_ACTIONS = len(TARGET_VELS)

# --- Observation / goals ----------------------------------------------------
OBS_DIM = 10         # merging_env.py:75, 118-132
NUM_GOALS = 3        # hdqn.py:31 (behind / alongside / ahead)

# Sentinel action meaning "None" in the reference API: player-2 acceleration
# is forced to 0 (the level-0 constant-velocity opponent, merging_env.py:152).
ACTION_NONE = -1

# Default start state (merging_env.py:216-217).
START_VEL = 20.0
