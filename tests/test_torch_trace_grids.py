"""dist_dqn_tpu_torch.utils.trace_grids on a small synthetic Chrome trace."""
import gzip
import json

from dist_dqn_tpu_torch.utils import trace_grids


def test_device_time_grouped_by_grid(tmp_path, capsys):
    events = [
        {"cat": "kernel", "name": "mul", "dur": 10.0,
         "args": {"grid": [10000, 1, 1]}},
        {"cat": "kernel", "name": "mul", "dur": 3.0,
         "args": {"grid": [1, 1, 1]}},
        {"cat": "kernel", "name": "add", "dur": 5.0,
         "args": {"grid": [10000, 1, 1]}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "dur": 2.0, "args": {}},
        {"cat": "cpu_op", "name": "aten::mul", "dur": 50.0, "args": {}},
    ]
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)

    device = trace_grids.load_device_events(str(path))
    assert len(device) == 4
    assert trace_grids.by_grid(device) == {(10000, 1, 1): (2, 15.0),
                                           (1, 1, 1): (1, 3.0),
                                           None: (1, 2.0)}

    trace_grids.main([str(path), "--top", "1", "--grid", "10000,1,1",
                      "--grid", "1,1,1"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"device_events": 4, "device_us": 20.0}
    assert rows[1] == {"grid": [10000, 1, 1], "launches": 2,
                       "device_us": 15.0, "share": 0.75}
    assert rows[2] == {"grids": [[10000, 1, 1], [1, 1, 1]], "launches": 3,
                       "device_us": 18.0, "share": 0.9}
