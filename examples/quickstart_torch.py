"""Library quickstart of the PyTorch port: build a scene in code, simulate,
inspect, checkpoint.

Run:  python examples/quickstart_torch.py        (needs a CUDA card)

Shows the object-level API (the same surface the CLI drives):
Scenario -> Simulator -> tick() -> list_pedestrians() -> a checkpoint
round trip -> a PNG snapshot (``logs/quickstart.png``), as the reference's
examples/quickstart.py does (matplotlib's, or a plain raster without it).
"""

import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from pedoni_tpu_torch import Scenario, Segment, Simulator, SimulatorOptions  # noqa: E402
from pedoni_tpu_torch.checkpoint import restore, save  # noqa: E402
from pedoni_tpu_torch.frames import save_frame  # noqa: E402
from pedoni_tpu_torch.scenario import PedestrianGroup, SpawnConfig  # noqa: E402


def build_scenario() -> Scenario:
    """A 40 x 14 m corridor with a mid-corridor pillar and two opposing
    pedestrian streams (the reference's lanes.toml in miniature)."""
    return Scenario(
        size=(40.0, 14.0),
        waypoints=(
            Segment(line=((1.0, 2.0), (1.0, 12.0)), width=1.0),    # west gate
            Segment(line=((39.0, 2.0), (39.0, 12.0)), width=1.0),  # east gate
        ),
        obstacles=(
            Segment(line=((20.0, 6.0), (20.0, 8.0)), width=2.0),   # pillar
        ),
        pedestrians=(
            PedestrianGroup(origin=0, destination=1,
                            spawn=SpawnConfig(kind="periodic", frequency=3.0)),
            PedestrianGroup(origin=1, destination=0,
                            spawn=SpawnConfig(kind="periodic", frequency=3.0)),
            PedestrianGroup(origin=0, destination=1,
                            spawn=SpawnConfig(kind="once", count=40)),
        ),
    )


def main(device: str = "cuda", n_steps: int = 200,
         png: str | pathlib.Path = "logs/quickstart.png") -> Simulator:
    scenario = build_scenario()
    # backend="xla" is the flat step (the default); "grid" runs the hand
    # kernels, and n_devices > 1 / tile=(r, c) cut its grid into tiles
    sim = Simulator(SimulatorOptions(backend="xla", seed=42, device=device),
                    scenario)

    for step in range(n_steps):
        rec = sim.tick()
        if step % 50 == 0:
            print(f"step {step:4d}: {rec.active_ped_count:4d} active, "
                  f"{rec.time_calc_state * 1000:6.2f} ms/step")

    pos, dest = sim.list_pedestrians()
    print(f"final: {len(pos)} agents; "
          f"x span [{pos[:, 0].min():.1f}, {pos[:, 0].max():.1f}] m")

    # checkpoint round trip (restores across backends and device counts)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "quickstart_ck.npz"
        save(sim, path)
        sim2 = Simulator(SimulatorOptions(backend="xla", seed=0, device=device),
                         scenario)
        restore(sim2, path)
    assert sim2.pedestrian_count == sim.pedestrian_count
    print(f"checkpoint restored at step {sim2.step_count}")

    pathlib.Path(png).parent.mkdir(parents=True, exist_ok=True)
    save_frame(scenario, pos, dest, str(png))
    print(f"wrote {png}")
    return sim


if __name__ == "__main__":
    main()
